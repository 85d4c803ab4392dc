"""3-nearest-neighbour mean squared distance for scale initialization
(the host half of ``h3dgs_tpu/ops/knn.py``, copied: scipy's KD-tree).
Used once at model init."""
from __future__ import annotations

import numpy as np


def mean_knn_dist2_host(xyz: np.ndarray, k: int = 3) -> np.ndarray:
    """[N,3] -> [N] mean squared distance to the k nearest neighbours."""
    from scipy.spatial import cKDTree

    xyz = np.asarray(xyz, np.float32)
    tree = cKDTree(xyz)
    # k+1 because the query point itself is its own 0-distance neighbour.
    dist, _ = tree.query(xyz, k=k + 1, workers=-1)
    return np.mean(dist[:, 1:] ** 2, axis=1).astype(np.float32)
