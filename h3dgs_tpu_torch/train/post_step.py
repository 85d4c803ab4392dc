"""Hierarchy-cut rendering (counterpart of the rendering half of
``h3dgs_tpu/train/post_step.py``: ``render_cut``, ``select_cut_gaussians``
and ``splat_cut_gaussians``; the post-training step is a later slice).

Row layout (create_from_hier parity): hierarchy nodes occupy rows [0, M);
skybox rows come LAST and are appended verbatim with weight 1; opacity
activation is |x|.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..hierarchy import cut as cut_lib
from ..model.state import GaussianState
from ..ops.rasterize import RasterizeConfig, rasterize
from ..scene.camera import Camera
from .step import apply_exposure


def render_cut(state: GaussianState, nodes: torch.Tensor,
               boxes: torch.Tensor, camera: Camera, limit, sh_degree: int,
               bg: torch.Tensor, raster_cfg: RasterizeConfig, max_cut: int,
               exposure: Optional[torch.Tensor] = None,
               params: Optional[dict] = None):
    """Select cut -> interpolate -> splat (render_post equivalent)."""
    if params is None:
        params = state.trainable_dict()
    xyz, scales, quats, opac, shs, cut = select_cut_gaussians(
        state, nodes, boxes, camera.to(state.device).cam_center, limit,
        max_cut, params=params)
    out = splat_cut_gaussians(xyz, scales, quats, opac, shs, camera,
                              sh_degree, bg, raster_cfg, exposure=exposure)
    out["cut"] = cut
    return out


def select_cut_gaussians(state: GaussianState, nodes, boxes, cam_center,
                         limit, max_cut: int, params=None, table=None):
    """Cut selection + LOD interpolation + skybox append -> flat splats.

    ``table``: optional cached interp_table(params) (the viewer's params
    are static, so interpolation is gather-only).
    """
    if params is None:
        params = state.trainable_dict()
    c = state.capacity
    n_sky = state.n_skybox
    cut = cut_lib.expand_to_size(nodes, boxes, limit, cam_center, max_cut)
    xyz, scales, quats, opac, shs = cut_lib.interpolate_cut(params, cut,
                                                            table)
    if n_sky:
        sky = slice(c - n_sky, c)
        xyz = torch.cat([xyz, params["xyz"][sky]])
        scales = torch.cat([scales, torch.exp(params["scaling"][sky])])
        quats = torch.cat([quats, params["rotation"][sky]])
        opac = torch.cat([opac, torch.abs(params["opacity"][sky, 0])])
        feats = torch.cat([params["f_dc"][sky], params["f_rest"][sky]],
                          dim=1)
        shs = torch.cat([shs, feats])
    return xyz, scales, quats, opac, shs, cut


def splat_cut_gaussians(xyz, scales, quats, opac, shs, camera: Camera,
                        sh_degree: int, bg, raster_cfg: RasterizeConfig,
                        exposure=None):
    """Rasterize pre-selected flat Gaussians (render_cut's second half)."""
    k = (sh_degree + 1) ** 2
    out = rasterize(xyz, scales, quats, opac, shs[:, :k], camera,
                    sh_degree, bg, config=raster_cfg)
    if exposure is not None:
        out["render"] = apply_exposure(out["render"], exposure)
    out["render"] = torch.clamp(out["render"], 0.0, 1.0)
    return out
