"""Hierarchy creator CLI (GaussianHierarchyCreator equivalent; counterpart
of ``h3dgs_tpu/cli/hierarchy_creator.py``).

  python -m h3dgs_tpu_torch.cli.hierarchy_creator \
      <point_cloud.ply> <chunk dir> <output dir> [<scaffold dir>] \
      [--backend auto|numpy|native]

Writes <output dir>/hierarchy.hier + anchors.bin. Skybox rows (pc_info.txt
next to the ply) are excluded: the post stage re-appends the scaffold's
skybox. Leaves outside the chunk bounds (center.txt / extent.txt) are
marked as anchors: they are scaffold-ring / boundary Gaussians that must
stay fixed during post-optimization. The tree is built on the host
(``hierarchy/tree.py:build_hierarchy``): ``--backend native`` runs the C++
builder (``native.py``, compiled from ``native/hierarchy_native.cpp`` at
first use), ``numpy`` the vectorized one, ``auto`` (the default) the C++
one when a C++ compiler is found. Both give the same structure, leaf set
and anchors, not always the same bytes (the C++ builder quantises Morton
codes in double, numpy in float32); the tool logs which ran. It uses no
device.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np


def _position_keys(xyz: np.ndarray) -> np.ndarray:
    """One opaque key per row: the position rounded to 5 decimals in
    float64 (-0.0 folded into 0.0), for exact matching with np.isin."""
    keys = np.ascontiguousarray(np.round(xyz.astype(np.float64), 5) + 0.0)
    return keys.view([("", keys.dtype)] * 3).reshape(-1)


def create_hierarchy(ply_path: str, chunk_dir: str, out_dir: str,
                     scaffold_dir: str = "", backend: str = "auto") -> str:
    from ..hierarchy.io import write_anchors, write_hier
    from ..hierarchy.tree import build_hierarchy, resolve_backend
    from ..io.meta import read_pc_info, read_vec
    from ..io.ply import read_gaussian_ply

    g = read_gaussian_ply(ply_path, sh_degree=3)
    n = g["xyz"].shape[0]
    info = os.path.join(os.path.dirname(ply_path), "pc_info.txt")
    n_skybox = read_pc_info(info) if os.path.exists(info) else 0

    sl = slice(n_skybox, n)
    xyz = g["xyz"][sl]
    shs = np.concatenate([g["features_dc"][sl].reshape(-1, 1, 3),
                          g["features_rest"][sl]], axis=1)
    alpha = 1.0 / (1.0 + np.exp(-g["opacity"][sl, 0]))
    scaling = g["scaling"][sl]
    rotation = g["rotation"][sl]

    locked = None
    center_f = os.path.join(chunk_dir, "center.txt")
    if os.path.exists(center_f):
        center = read_vec(center_f)
        extent = read_vec(os.path.join(chunk_dir, "extent.txt"))
        out = np.zeros(xyz.shape[0], bool)
        for a in (0, 1):
            out |= np.abs(xyz[:, a] - center[a]) > extent[a] / 2
        locked = out
        print(f"{int(out.sum())}/{xyz.shape[0]} out-of-chunk leaves "
              "marked as anchors")

    # Scaffold-position anchoring (the native tool's 4th argument). The
    # chunk keeps scaffold rows in a Chebyshev ring >= 0.5x extent, so the
    # bounds test above already anchors them; exact-position matching
    # against the scaffold cloud catches rows that drifted inside the box
    # (scaffold rows are shrink-protected, not frozen).
    if scaffold_dir:
        sc_ply = os.path.join(scaffold_dir, "point_cloud.ply")
        if os.path.exists(sc_ply):
            sc = read_gaussian_ply(sc_ply, sh_degree=1)
            match = np.isin(_position_keys(xyz), _position_keys(sc["xyz"]))
            locked = match if locked is None else locked | match
            print(f"{int(match.sum())} scaffold-position leaves "
                  "marked as anchors")

    backend = resolve_backend(backend)
    t0 = time.perf_counter()
    h = build_hierarchy(xyz, shs, alpha, scaling, rotation,
                        locked_leaf_mask=locked, backend=backend)
    print(f"hierarchy built by the {backend} backend in "
          f"{time.perf_counter() - t0:.2f} s")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "hierarchy.hier")
    write_hier(out_path, h)
    write_anchors(os.path.join(out_dir, "anchors.bin"), h.anchors)
    print(f"hierarchy: {h.n_nodes} nodes ({h.n_leaves} leaves, "
          f"{h.anchors.size} anchors) -> {out_path}")
    return out_path


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    backend = "auto"
    if "--backend" in argv:
        i = argv.index("--backend")
        backend = argv[i + 1]
        del argv[i:i + 2]
    if len(argv) < 3:
        print(__doc__)
        sys.exit(2)
    create_hierarchy(argv[0], argv[1], argv[2],
                     argv[3] if len(argv) > 3 else "", backend=backend)


if __name__ == "__main__":
    main()
