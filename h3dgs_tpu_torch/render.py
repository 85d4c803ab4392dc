"""Renderer facade with the reference's API surface and output keys
(counterpart of ``h3dgs_tpu/render.py``).

  render(camera, state, bg)            -> {"render", "depth",
                                           "viewspace_points",
                                           "visibility_filter", "radii", ...}
  render_post(camera, state, nodes, boxes, limit, ...)  (hierarchy cut)
  render_coarse(camera, state, bg)     (no depth output read)

"viewspace_points" is the zeros [N, 2] means2d offset whose gradient is
the densification signal (pass your own, with ``requires_grad``, to
differentiate); "depth" is inverse depth. All three run on ``device``:
the card unless the caller passes ``device="cpu"`` (they raise when CUDA
is missing and no device was asked for); inputs are moved there. On the
card every call launches the blend forward kernel (K1).
"""
from __future__ import annotations

from typing import Optional

import torch

from .model.state import GaussianState
from .ops.rasterize import RasterizeConfig, rasterize
from .scene.camera import Camera
from .train.post_step import render_cut
from .train.step import apply_exposure
from .utils.runtime import as_tensor, resolve_device


def _as_reference_dict(out, means2d_offset):
    return {
        "render": out["render"],
        "depth": out["invdepth"],
        "viewspace_points": means2d_offset,
        "visibility_filter": out["visibility_filter"],
        "radii": out["radii"],
        "final_transmittance": out["final_transmittance"],
        "n_duplicates": out["n_duplicates"],
    }


def render(viewpoint_camera: Camera, state: GaussianState, bg_color,
           scaling_modifier: float = 1.0, sh_degree: Optional[int] = None,
           use_trained_exp: bool = False,
           exposure: Optional[torch.Tensor] = None,
           means2d_offset: Optional[torch.Tensor] = None,
           indices=None,
           config: RasterizeConfig = RasterizeConfig(),
           device=None):
    """Single-chunk training render.

    ``indices``: optional int [M] subset of rows to splat, every entry a
    valid row. The JAX function takes a static-size bucket padded with -1;
    the port takes the exact index tensor, and raises on a negative or
    out-of-range entry. ``visibility_filter`` and ``radii`` are scattered
    back to all N rows; gradients (``means2d_offset``'s too) reach the
    selected rows through the gather. With ``use_trained_exp`` and an
    ``exposure`` row, the image is exposure-corrected and clipped to
    [0, 1].
    """
    dev = resolve_device(device)
    state = state.to(dev)
    deg = state.max_sh_degree if sh_degree is None else sh_degree
    n = state.capacity
    if means2d_offset is None:
        means2d_offset = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    xyz = state.xyz
    scaling = state.get_scaling()
    rotation = state.get_rotation()
    opacity = state.get_opacity()[:, 0]
    features = state.get_features(deg)
    m2d = means2d_offset
    if indices is not None:
        idx = as_tensor(indices, dev, torch.int64)
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n):
            raise ValueError(f"indices must lie in [0, {n}): the port takes "
                             "an exact subset, not a -1-padded bucket")
        xyz, scaling, rotation = xyz[idx], scaling[idx], rotation[idx]
        opacity, features, m2d = opacity[idx], features[idx], m2d[idx]
    out = rasterize(xyz, scaling, rotation, opacity, features,
                    viewpoint_camera, deg,
                    as_tensor(bg_color, dev, torch.float32),
                    scale_modifier=scaling_modifier, means2d_offset=m2d,
                    config=config)
    if use_trained_exp and exposure is not None:
        out["render"] = torch.clamp(
            apply_exposure(out["render"],
                           as_tensor(exposure, dev, torch.float32)),
            0.0, 1.0)
    if indices is not None:
        vis = torch.zeros(n, dtype=torch.bool, device=dev)
        vis[idx] = out["visibility_filter"]
        radii = torch.zeros(n, dtype=out["radii"].dtype, device=dev)
        radii[idx] = out["radii"]
        out = dict(out, visibility_filter=vis, radii=radii)
    return _as_reference_dict(out, means2d_offset)


# Coarse-scaffold render: the same splat, its depth output simply unused
# by the coarse loss.
render_coarse = render


def render_post(viewpoint_camera: Camera, state: GaussianState,
                nodes, boxes, limit, bg_color, max_cut: int,
                sh_degree: Optional[int] = None,
                exposure: Optional[torch.Tensor] = None,
                config: RasterizeConfig = RasterizeConfig(),
                device=None):
    """Hierarchy-cut render. ``limit`` is the granularity threshold
    (hierarchy.cut.pixel_limit)."""
    dev = resolve_device(device)
    deg = state.max_sh_degree if sh_degree is None else sh_degree
    out = render_cut(state.to(dev), as_tensor(nodes, dev),
                     as_tensor(boxes, dev, torch.float32),
                     viewpoint_camera.to(dev),
                     as_tensor(limit, dev, torch.float32), deg,
                     as_tensor(bg_color, dev, torch.float32), config,
                     max_cut=max_cut,
                     exposure=(None if exposure is None
                               else as_tensor(exposure, dev, torch.float32)))
    res = _as_reference_dict(out, None)
    res["cut"] = out["cut"]
    return res
