"""Model initialization from a hierarchy (host-side).

Counterpart of ``h3dgs_tpu/model/init.py:state_from_hierarchy``: the
reference create_from_hier layout — hierarchy rows first, then the
scaffold's skybox rows (their opacity sigmoid-activated, since post mode
uses |x| activation on stored values); anchors become a locked-row mask.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..io.ply import read_gaussian_ply
from . import state as state_lib


def state_from_hierarchy(hier, scaffold_dir: str = "",
                         capacity: Optional[int] = None,
                         max_sh_degree: int = 3, device=None):
    """Build the post-mode GaussianState from a hierarchy on ``device``.

    ``scaffold_dir`` holds a coarse scaffold's ``point_cloud.ply``
    (degree 1) and ``pc_info.txt`` (its skybox row count on the first
    line); its skybox rows are appended LAST.

    Returns (state, anchor_mask [capacity] bool numpy).
    """
    m = hier.n_nodes
    xyz = hier.xyz
    f_dc = hier.shs[:, :1, :]
    f_rest = hier.shs[:, 1:16, :]
    opacity = hier.alpha.reshape(m, 1)
    scaling = hier.scaling
    rotation = hier.rotation

    n_skybox = 0
    if scaffold_dir:
        g = read_gaussian_ply(os.path.join(scaffold_dir, "point_cloud.ply"),
                              sh_degree=1)
        with open(os.path.join(scaffold_dir, "pc_info.txt")) as f:
            n_skybox = int(f.readline())
        if n_skybox > 0:
            sl = slice(0, n_skybox)
            rest = np.zeros((n_skybox, state_lib.SH_REST, 3), np.float32)
            rest[:, :3, :] = g["features_rest"][sl]
            sky_op = 1.0 / (1.0 + np.exp(-g["opacity"][sl]))
            xyz = np.concatenate([xyz, g["xyz"][sl]])
            f_dc = np.concatenate([f_dc, g["features_dc"][sl].reshape(
                n_skybox, 1, 3)])
            f_rest = np.concatenate([f_rest, rest])
            opacity = np.concatenate([opacity, sky_op.reshape(n_skybox, 1)])
            scaling = np.concatenate([scaling, g["scaling"][sl]])
            rotation = np.concatenate([rotation, g["rotation"][sl]])

    n = xyz.shape[0]
    capacity = capacity or n
    state = state_lib.from_arrays(
        xyz, f_dc, f_rest, opacity, scaling, rotation,
        capacity=capacity, max_sh_degree=max_sh_degree, device=device,
        n_skybox=n_skybox, skybox_last=True, opacity_abs=True)
    anchor_mask = np.zeros(capacity, bool)
    anchor_mask[hier.anchors] = True
    return state, anchor_mask
