"""Hierarchy-cut rendering and the hierarchy fine-tuning step
(counterpart of ``h3dgs_tpu/train/post_step.py``).

One post step: select the view-adaptive cut for a sampled granularity
limit, lerp child and parent attributes (differentiable LOD), splat,
photometric loss, one ``torch.autograd.grad`` through the blend (K1
forward, K2 backward), the projection and the interpolation table, zero
the anchor and skybox gradients, dense Adam. The spans ``post.forward``,
``post.loss``, ``post.backward`` and, in the update, ``update.lock`` and
``update.adam`` mark its stages; the selection is the span ``cut.select``
and the counter ``cut.rows`` wherever it runs (``utils/profiling.py``).

Row layout (create_from_hier parity): hierarchy nodes occupy rows [0, M);
skybox rows come LAST and are appended verbatim with weight 1; opacity
activation is |x|.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..config import OptimizationConfig
from ..hierarchy import cut as cut_lib
from ..model.state import GaussianState
from ..ops import adam as adam_lib
from ..ops.rasterize import RasterizeConfig, rasterize
from ..scene.camera import Camera
from ..scene.views import ViewBatch
from ..utils import losses as loss_lib
from ..utils import profiling, schedules
from .step import apply_exposure

LIMIT_MIN = 0.005
LIMIT_MAX = 0.1


def sample_limit(generator: torch.Generator) -> torch.Tensor:
    """Log-uniform granularity target in [LIMIT_MIN, LIMIT_MAX], a scalar
    on the generator's device."""
    u = torch.rand((), generator=generator, device=generator.device)
    lo, hi = math.log2(LIMIT_MIN), math.log2(LIMIT_MAX)
    return torch.exp2(u * (hi - lo) + lo)


class PostStepOutput(NamedTuple):
    state: GaussianState
    opt: adam_lib.AdamState
    photo_loss: torch.Tensor
    cut_size: torch.Tensor      # true cut size
    n_visible: torch.Tensor


def render_cut(state: GaussianState, nodes: torch.Tensor,
               boxes: torch.Tensor, camera: Camera, limit, sh_degree: int,
               bg: torch.Tensor, raster_cfg: RasterizeConfig,
               max_cut: Optional[int],
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
                         limit, max_cut: Optional[int], params=None,
                         table=None):
    """Cut selection + LOD interpolation + skybox append -> flat splats.
    ``max_cut=None`` sizes the cut exactly.

    ``table``: optional cached interp_table(params) (the viewer's params
    are static, so interpolation is gather-only).

    Runs in the span ``cut.select``; the counter ``cut.rows`` adds the
    cut's size as the selection read it on the host.
    """
    if params is None:
        params = state.trainable_dict()
    c = state.capacity
    n_sky = state.n_skybox
    with profiling.span("cut.select"):
        cut = cut_lib.expand_to_size(nodes, boxes, limit, cam_center,
                                     max_cut)
        profiling.count("cut.rows", cut.size)
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
                        exposure=None, band_devices=None):
    """Rasterize pre-selected flat Gaussians (render_cut's second half).
    ``band_devices`` (two or more) renders the frame in pixel bands, one
    per device (``parallel/band_render.py``; forward only)."""
    k = (sh_degree + 1) ** 2
    if band_devices is not None and len(band_devices) > 1:
        from ..parallel.band_render import render_banded
        out = render_banded(xyz, scales, quats, opac, shs[:, :k], camera,
                            sh_degree, bg, band_devices, config=raster_cfg)
    else:
        out = rasterize(xyz, scales, quats, opac, shs[:, :k], camera,
                        sh_degree, bg, config=raster_cfg)
    if exposure is not None:
        out["render"] = apply_exposure(out["render"], exposure)
    out["render"] = torch.clamp(out["render"], 0.0, 1.0)
    return out


class PostViewGrads(NamedTuple):
    """One view's post-training loss gradients."""
    g_params: dict               # name -> [C, ...] gradient
    photo_loss: torch.Tensor
    cut_size: torch.Tensor       # true cut size
    n_visible: torch.Tensor


def make_post_view_grads(opt_cfg: OptimizationConfig,
                         raster_cfg: RasterizeConfig,
                         use_exposure: bool = True):
    """The cut render of one view at its own limit and exposure row, its
    photometric loss and one ``torch.autograd.grad`` (K1, K2)."""

    def view_grads(state: GaussianState, batch: ViewBatch,
                   nodes: torch.Tensor, boxes: torch.Tensor,
                   exposure_row: torch.Tensor, limit, bg: torch.Tensor,
                   sh_degree: int) -> PostViewGrads:
        exp_row = exposure_row if use_exposure else None
        names = list(state.trainable_dict())
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state.trainable_dict().items()}
        with torch.enable_grad():
            with profiling.span("post.forward"):
                out = render_cut(state, nodes, boxes, batch.camera, limit,
                                 sh_degree, bg, raster_cfg, None,
                                 exposure=exp_row, params=params)
            with profiling.span("post.loss"):
                image = out["render"] * batch.alpha_mask
                photo = loss_lib.photometric_loss(image, batch.gt_image,
                                                  opt_cfg.lambda_dssim)
            with profiling.span("post.backward"):
                grads = torch.autograd.grad(photo,
                                            [params[k] for k in names],
                                            allow_unused=True,
                                            materialize_grads=True)
        return PostViewGrads(
            g_params=dict(zip(names, grads)), photo_loss=photo.detach(),
            cut_size=out["cut"].count,
            n_visible=out["visibility_filter"].sum())

    return view_grads


def make_post_update(opt_cfg: OptimizationConfig,
                     skybox_locked: bool = True):
    """Zero the anchor and skybox gradients, then one dense Adam step
    (eps 1e-15) over every row."""

    @torch.no_grad()
    def update(state: GaussianState, opt: adam_lib.AdamState,
               g_params: dict, anchor_mask: torch.Tensor, iteration,
               spatial_lr_scale):
        with profiling.span("update.lock"):
            locked = anchor_mask
            if skybox_locked and state.n_skybox:
                locked = locked | state.locked_rows_mask()
            for k in g_params:
                m = locked.reshape((-1,) + (1,) * (g_params[k].dim() - 1))
                g_params[k] = torch.where(m, torch.zeros_like(g_params[k]),
                                          g_params[k])
        with profiling.span("update.adam"):
            lrs = schedules.gaussian_lr_dict(opt_cfg, float(iteration))
            lrs["xyz"] = lrs["xyz"] * float(spatial_lr_scale)
            all_rows = torch.ones(state.capacity, dtype=torch.bool,
                                  device=state.device)
            new_params, new_opt = adam_lib.sparse_adam_update(
                state.trainable_dict(), g_params, opt, lrs, all_rows)
        return state.replace_trainable(new_params), new_opt

    return update


def make_post_train_step(opt_cfg: OptimizationConfig,
                         raster_cfg: RasterizeConfig,
                         skybox_locked: bool = True,
                         use_exposure: bool = True):
    """Build the post-optimization step: the data-parallel post step of
    ``parallel/step.py`` over one view (its gradients from
    ``make_post_view_grads``, then ``make_post_update``).

    The exposure row is the *pretrained* per-image transform (loaded from
    exposure.json): applied, never optimized. Every cut is sized exactly
    from the selection (the reference's ``max_cut`` capacity, which its
    static shapes need and which can truncate, has no counterpart). The
    step is a plain eager function; the update runs under
    ``torch.no_grad()`` and returns new tensors.
    """
    from ..parallel.step import make_dp_post_step  # it imports this module

    dp_step = make_dp_post_step(opt_cfg, raster_cfg, skybox_locked,
                                use_exposure)

    def step(state: GaussianState, opt: adam_lib.AdamState,
             batch: ViewBatch, nodes: torch.Tensor, boxes: torch.Tensor,
             anchor_mask: torch.Tensor, exposure_row: torch.Tensor,
             limit, iteration, bg: torch.Tensor, spatial_lr_scale,
             sh_degree: int) -> PostStepOutput:
        return dp_step(state, opt, [batch], nodes, boxes, anchor_mask,
                       [exposure_row], [limit], iteration, bg,
                       spatial_lr_scale, sh_degree)

    return step
