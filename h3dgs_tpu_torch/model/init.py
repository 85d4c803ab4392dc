"""Model initialization from point clouds, scaffolds and hierarchies
(host-side; counterpart of ``h3dgs_tpu/model/init.py``).

``init_from_pcd`` reproduces the reference's create_from_pcd:
  * optional procedural skybox: points on a sphere of radius 10x the scene
    half-diagonal, sky-tinted (0.7, 0.8, 0.95), opacity 0.7, scales x10;
  * scene points: SH-DC from RGB, log-scale from sqrt(mean 3-NN squared
    distance) (clamped), identity rotations, opacity 0.01 (0.02 when a
    skybox is synthesized);
  * optional scaffold: a trained coarse PLY's skybox rows plus Gaussians
    in a ring 0.5-1.5x chunk extent around the chunk center (Chebyshev
    metric on x/y), prepended and protected.
Row layout: [skybox | scaffold ring | scene points].

``state_from_hierarchy`` is the create_from_hier layout: hierarchy rows
first, then the scaffold's skybox rows (their opacity sigmoid-activated,
since post mode uses |x| activation on stored values); anchors become a
locked-row mask; ``update_hierarchy_from_state`` writes the trained rows
back into the hierarchy.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from ..io.ply import read_gaussian_ply
from ..ops.knn import mean_knn_dist2_host
from ..utils.sh import rgb_to_sh
from . import state as state_lib


def _inverse_sigmoid_np(x):
    return np.log(x / (1.0 - x))


def synth_skybox(n: int, points_xyz: np.ndarray, seed: int = 0):
    """Skybox sphere points + colors (gaussian_model.py:169-184)."""
    rng = np.random.default_rng(seed)
    mn = points_xyz.min(axis=0)
    mx = points_xyz.max(axis=0)
    mean = 0.5 * (mn + mx)
    radius = np.linalg.norm(mx - mean)
    theta = 2.0 * np.pi * rng.random(n)
    phi = np.arccos(1.0 - 1.4 * rng.random(n))
    xyz = np.stack([
        radius * 10 * np.cos(theta) * np.sin(phi),
        radius * 10 * np.sin(theta) * np.sin(phi),
        radius * 10 * np.cos(phi),
    ], axis=1).astype(np.float32) + mean.astype(np.float32)
    color = np.tile(np.asarray([0.7, 0.8, 0.95], np.float32), (n, 1))
    return xyz, color


def load_scaffold(scaffold_dir: str, center: np.ndarray, extent: np.ndarray):
    """Select scaffold Gaussians around a chunk (gaussian_model.py:208-247).

    Returns (arrays dict, n_selected, n_skybox). The scaffold PLY is
    degree 1; its rest coefficients are zero-padded to degree 3.
    """
    g = read_gaussian_ply(os.path.join(scaffold_dir, "point_cloud.ply"),
                          sh_degree=1)
    with open(os.path.join(scaffold_dir, "pc_info.txt")) as f:
        n_skybox = int(f.readline())

    d = np.abs(g["xyz"] - center[None, :])
    cheb = np.maximum(d[:, 0], d[:, 1])
    selec = (cheb > 0.5 * extent[0]) & (cheb < 1.5 * extent[0])
    selec[:n_skybox] = True

    rest = np.zeros((g["xyz"].shape[0], state_lib.SH_REST, 3), np.float32)
    rest[:, :3, :] = g["features_rest"]
    out = dict(
        xyz=g["xyz"][selec],
        features_dc=g["features_dc"][selec],
        features_rest=rest[selec],
        opacity=g["opacity"][selec],
        scaling=g["scaling"][selec],
        rotation=g["rotation"][selec],
    )
    return out, int(selec.sum()), n_skybox


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


def update_hierarchy_from_state(hier, state):
    """Write post-optimized rows [0, M) back into the hierarchy (the
    reference's save_hier path): alpha = |opacity|."""
    m = hier.n_nodes

    def rows(t):
        return t[:m].detach().cpu().numpy()

    shs = np.concatenate([rows(state.features_dc),
                          rows(state.features_rest)], axis=1)
    return dataclasses.replace(
        hier, xyz=rows(state.xyz), shs=shs.astype(np.float32),
        alpha=np.abs(rows(state.opacity)[:, 0]),
        scaling=rows(state.scaling), rotation=rows(state.rotation))


def init_from_pcd(
    points_xyz: np.ndarray,
    points_rgb: np.ndarray,
    capacity: Optional[int] = None,
    capacity_factor: float = 1.0,
    max_sh_degree: int = 3,
    skybox_points: int = 0,
    scaffold_dir: str = "",
    chunk_center: Optional[np.ndarray] = None,
    chunk_extent: Optional[np.ndarray] = None,
    seed: int = 0,
    device=None,
) -> state_lib.GaussianState:
    """A training state on ``device`` from an input point cloud."""
    points_xyz = np.asarray(points_xyz, np.float32)
    points_rgb = np.asarray(points_rgb, np.float32)

    # A scaffold brings its own skybox (gaussian_model.py:166-168).
    synth_sky = skybox_points if not scaffold_dir else 0

    xyz = points_xyz
    rgb = points_rgb
    if synth_sky > 0:
        sky_xyz, sky_rgb = synth_skybox(synth_sky, points_xyz, seed)
        xyz = np.concatenate([sky_xyz, xyz])
        rgb = np.concatenate([sky_rgb, rgb])

    n = xyz.shape[0]
    features_dc = rgb_to_sh(rgb).astype(np.float32)[:, None, :]
    features_rest = np.zeros((n, state_lib.SH_REST, 3), np.float32)

    dist2 = np.maximum(mean_knn_dist2_host(xyz), 1e-7)
    if not scaffold_dir and synth_sky > 0:
        dist2[:synth_sky] *= 10.0
        dist2[synth_sky:] = np.minimum(dist2[synth_sky:], 10.0)
    scaling = np.log(np.sqrt(dist2))[:, None].repeat(3, axis=1)
    rotation = np.zeros((n, 4), np.float32)
    rotation[:, 0] = 1.0

    if not scaffold_dir and synth_sky > 0:
        opacity = _inverse_sigmoid_np(np.full((n, 1), 0.02, np.float32))
        # Raw 0.7 in pre-activation space, as the reference stores it.
        opacity[:synth_sky] = 0.7
    else:
        opacity = _inverse_sigmoid_np(np.full((n, 1), 0.01, np.float32))

    n_skybox = synth_sky
    n_scaffold = 0
    if scaffold_dir:
        sc, n_scaffold, n_skybox = load_scaffold(
            scaffold_dir, np.asarray(chunk_center, np.float32),
            np.asarray(chunk_extent, np.float32))
        xyz = np.concatenate([sc["xyz"], xyz])
        features_dc = np.concatenate([sc["features_dc"], features_dc])
        features_rest = np.concatenate([sc["features_rest"], features_rest])
        opacity = np.concatenate([sc["opacity"], opacity])
        scaling = np.concatenate([sc["scaling"], scaling])
        rotation = np.concatenate([sc["rotation"], rotation])

    # Densify headroom applies to the scene points only; skybox/scaffold
    # rows are protected and never densify.
    n_total = xyz.shape[0]
    n_protected = max(n_skybox, n_scaffold)
    if capacity is None:
        capacity = n_protected + int(
            (n_total - n_protected) * max(capacity_factor, 1.0))
    capacity = max(capacity, n_total)
    return state_lib.from_arrays(
        xyz, features_dc, features_rest, opacity, scaling, rotation,
        capacity=capacity, max_sh_degree=max_sh_degree, device=device,
        n_skybox=n_skybox, n_scaffold=n_scaffold)
