"""Renderer facade with the reference's API surface and output keys.

Counterpart of ``h3dgs_tpu/render.py`` for the serving path:
``render_post`` (hierarchy cut with parent<->child interpolation). The
flat training renders come with the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from .model.state import GaussianState
from .ops.rasterize import RasterizeConfig
from .scene.camera import Camera
from .train.post_step import render_cut
from .utils.runtime import as_tensor, resolve_device


def render_post(viewpoint_camera: Camera, state: GaussianState,
                nodes, boxes, limit, bg_color, max_cut: int,
                sh_degree: Optional[int] = None,
                exposure: Optional[torch.Tensor] = None,
                config: RasterizeConfig = RasterizeConfig(),
                device=None):
    """Hierarchy-cut render. ``limit`` is the granularity threshold
    (hierarchy.cut.pixel_limit). Runs on ``device``: the card unless the
    caller passes ``device="cpu"`` (raises when CUDA is missing and no
    device was asked for); inputs are moved there."""
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
    return {
        "render": out["render"],
        "depth": out["invdepth"],
        "viewspace_points": None,
        "visibility_filter": out["visibility_filter"],
        "radii": out["radii"],
        "final_transmittance": out["final_transmittance"],
        "n_duplicates": out["n_duplicates"],
        "cut": out["cut"],
    }
