"""The per-view training step of flat-model training (counterpart of
``h3dgs_tpu/train/step.py``).

One step (``make_view_grads`` then ``make_update``, run by the
data-parallel step of ``parallel/step.py``, which ``make_train_step``
calls with one view): render -> photometric (+ optional inverse-depth) loss -> one
``torch.autograd.grad`` through the projection and the blend (K1 forward,
K2 backward) -> skybox gradient locking -> densification stats from the
screen-space offset gradient -> masked sparse Adam -> exposure Adam ->
big-Gaussian shrink, in the reference's order. It is a plain eager
function: the updates run under ``torch.no_grad()`` and return new
tensors. ``StepOutput`` has no counterpart of the JAX step's entry-budget
counters (``n_truncated``, ``n_raw``, ``n_bwd_quanta``), and ``rasterize``
no longer returns them: they size the TPU's static buffers, which the
port does not have. Densify / prune and the opacity reset run on their
own intervals (``densify_step``, ``reset_opacity_step``). The spans
``train.forward``, ``train.loss``, ``train.backward`` and, in the update,
``update.lock``, ``update.stats``, ``update.adam`` and ``update.shrink``
mark its stages (``utils/profiling.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import OptimizationConfig
from ..model import densify as densify_lib
from ..model.state import GaussianState
from ..ops import adam as adam_lib
from ..ops.rasterize import RasterizeConfig, rasterize
from ..scene.camera import Camera
from ..scene.views import ViewBatch
from ..utils import losses as loss_lib
from ..utils import profiling, schedules


class StepOutput(NamedTuple):
    state: GaussianState
    opt: adam_lib.AdamState
    exposure: torch.Tensor
    exposure_opt: adam_lib.AdamState
    photo_loss: torch.Tensor
    depth_loss: torch.Tensor
    n_visible: torch.Tensor
    n_duplicates: torch.Tensor


def apply_exposure(image: torch.Tensor, exposure: torch.Tensor) -> torch.Tensor:
    """3x4 affine color transform of a [3,H,W] image. Summed per channel
    in float32 (no matmul, so no TF32 whatever the backend settings)."""
    m = exposure[:3, :3]
    out = (image[:, None] * m[:, :, None, None]).sum(dim=0)
    return out + exposure[:3, 3][:, None, None]


def render_for_training(state: GaussianState, camera: Camera,
                        sh_degree: int, bg: torch.Tensor,
                        raster_cfg: RasterizeConfig,
                        means2d_offset: Optional[torch.Tensor] = None,
                        exposure: Optional[torch.Tensor] = None):
    out = rasterize(
        state.xyz, state.get_scaling(), state.get_rotation(),
        state.get_opacity()[:, 0], state.get_features(sh_degree),
        camera, sh_degree, bg,
        means2d_offset=means2d_offset, config=raster_cfg)
    image = out["render"]
    if exposure is not None:
        image = apply_exposure(image, exposure)
    out["render"] = torch.clamp(image, 0.0, 1.0)
    return out


class ViewGrads(NamedTuple):
    """One view's loss gradients and what the update reads of its
    render. C is the capacity of the state given: in the dp step, the
    rows below the store's high-water mark."""
    g_params: dict                # name -> [C, ...] gradient
    g_exposure: Optional[torch.Tensor]  # [3, 4] of the view's row
    g_offset: torch.Tensor        # [C, 2] screen-space offset gradient
    radii: torch.Tensor           # [C] int32
    visible: torch.Tensor         # [C] bool
    photo_loss: torch.Tensor
    depth_loss: torch.Tensor
    n_duplicates: torch.Tensor


def make_view_grads(opt_cfg: OptimizationConfig,
                    raster_cfg: RasterizeConfig,
                    use_depth_loss: bool = True, use_exposure: bool = True):
    """The loss of one view and one ``torch.autograd.grad`` through the
    projection and the blend (K1 forward, K2 backward)."""

    def view_grads(state: GaussianState, exposure: torch.Tensor,
                   batch: ViewBatch, iteration, bg: torch.Tensor,
                   sh_degree: int) -> ViewGrads:
        names = list(state.trainable_dict())
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state.trainable_dict().items()}
        offset = torch.zeros((state.capacity, 2), dtype=torch.float32,
                             device=state.device, requires_grad=True)
        exp_row = (exposure[batch.image_idx].detach().requires_grad_(True)
                   if use_exposure else None)
        depth_w = schedules.expon_lr(
            float(iteration), opt_cfg.depth_l1_weight_init,
            opt_cfg.depth_l1_weight_final, max_steps=opt_cfg.iterations)

        with torch.enable_grad():
            st = state.replace_trainable(params)
            with profiling.span("train.forward"):
                out = render_for_training(st, batch.camera, sh_degree, bg,
                                          raster_cfg, means2d_offset=offset,
                                          exposure=exp_row)
            with profiling.span("train.loss"):
                image = out["render"] * batch.alpha_mask
                photo = loss_lib.photometric_loss(image, batch.gt_image,
                                                  opt_cfg.lambda_dssim)
                if use_depth_loss:
                    d_l1 = torch.mean(torch.abs(out["invdepth"]
                                                - batch.invdepth)
                                      * batch.depth_mask)
                    depth = torch.where(batch.depth_reliable & (depth_w > 0),
                                        depth_w * d_l1,
                                        torch.zeros_like(d_l1))
                else:
                    depth = torch.zeros((), device=state.device)
            inputs = [params[k] for k in names] + [offset]
            if use_exposure:
                inputs.append(exp_row)
            with profiling.span("train.backward"):
                grads = torch.autograd.grad(photo + depth, inputs,
                                            allow_unused=True,
                                            materialize_grads=True)
        return ViewGrads(
            g_params=dict(zip(names, grads[:len(names)])),
            g_exposure=grads[len(names) + 1] if use_exposure else None,
            g_offset=grads[len(names)], radii=out["radii"],
            visible=out["visibility_filter"], photo_loss=photo.detach(),
            depth_loss=depth.detach(), n_duplicates=out["n_duplicates"])

    return view_grads


def make_update(opt_cfg: OptimizationConfig, use_exposure: bool = True,
                skybox_locked: bool = True, freeze_xyz: bool = False,
                shrink_threshold: float = 0.02,
                shrink_protect_scaffold: bool = True,
                skip_shrink: bool = False):
    """Everything after the gradients, once a step: skybox gradient
    locking -> densification stats from the screen-space offset gradient
    -> masked sparse Adam -> exposure Adam -> big-Gaussian shrink.
    ``g_exposure`` is the gradient of the whole exposure table."""

    @torch.no_grad()
    def update(state: GaussianState, opt: adam_lib.AdamState,
               exposure: torch.Tensor, exposure_opt: adam_lib.AdamState,
               g_params: dict, g_exposure: Optional[torch.Tensor],
               g_offset: torch.Tensor, radii: torch.Tensor,
               visible: torch.Tensor, iteration, spatial_lr_scale,
               cameras_extent):
        it = float(iteration)
        # --- skybox gradient locking (train_single.py:162-168) ---
        if skybox_locked:
            with profiling.span("update.lock"):
                locked = state.locked_rows_mask()
                for k in g_params:
                    m = locked.reshape((-1,) + (1,) * (g_params[k].dim()
                                                       - 1))
                    g_params[k] = torch.where(m, torch.zeros_like(
                        g_params[k]), g_params[k])

        # --- densification stats (screen-space positional grads) ---
        with profiling.span("update.stats"):
            new_state = densify_lib.add_densification_stats(
                state, g_offset, radii, visible)

        with profiling.span("update.adam"):
            # --- sparse Adam on rows with a nonzero opacity gradient ---
            relevant = (g_params["opacity"][:, 0] != 0.0) & state.alive
            lrs = schedules.gaussian_lr_dict(opt_cfg, it,
                                             freeze_xyz=freeze_xyz)
            lrs["xyz"] = lrs["xyz"] * float(spatial_lr_scale)
            new_params, new_opt = adam_lib.sparse_adam_update(
                state.trainable_dict(), g_params, opt, lrs, relevant)
            new_state = new_state.replace_trainable(new_params)

            # --- exposure Adam (dense, torch defaults: eps 1e-8) ---
            if use_exposure:
                exp_lr = schedules.expon_lr(
                    it, opt_cfg.exposure_lr_init, opt_cfg.exposure_lr_final,
                    lr_delay_steps=opt_cfg.exposure_lr_delay_steps,
                    lr_delay_mult=opt_cfg.exposure_lr_delay_mult,
                    max_steps=opt_cfg.iterations)
                all_rows = torch.ones(exposure.shape[0], dtype=torch.bool,
                                      device=exposure.device)
                new_exp, exposure_opt = adam_lib.sparse_adam_update(
                    {"exposure": exposure}, {"exposure": g_exposure},
                    exposure_opt, {"exposure": exp_lr}, all_rows, eps=1e-8)
                exposure = new_exp["exposure"]

        # --- every-iteration big-Gaussian shrink ---
        if not skip_shrink:
            with profiling.span("update.shrink"):
                new_state = densify_lib.shrink_big_gaussians(
                    new_state, cameras_extent, shrink_threshold,
                    protect_scaffold=shrink_protect_scaffold)
        return new_state, new_opt, exposure, exposure_opt

    return update


def make_train_step(opt_cfg: OptimizationConfig, raster_cfg: RasterizeConfig,
                    use_depth_loss: bool = True, use_exposure: bool = True,
                    skybox_locked: bool = True, freeze_xyz: bool = False,
                    shrink_threshold: float = 0.02,
                    shrink_protect_scaffold: bool = True,
                    skip_shrink: bool = False):
    """Build the train step for a given config: the data-parallel step of
    ``parallel/step.py`` over one view (its gradients from
    ``make_view_grads``, then ``make_update``), with no division and no
    reduction.

    freeze_xyz / shrink_threshold=0.1 / use_depth_loss=False /
    use_exposure=False reproduce the coarse trainer's variant.
    """
    from ..parallel.step import make_dp_train_step  # it imports this module

    dp_step = make_dp_train_step(
        opt_cfg, raster_cfg, use_depth_loss, use_exposure, skybox_locked,
        freeze_xyz, shrink_threshold, shrink_protect_scaffold, skip_shrink)

    def step(state: GaussianState, opt: adam_lib.AdamState,
             exposure: torch.Tensor, exposure_opt: adam_lib.AdamState,
             batch: ViewBatch, iteration, bg: torch.Tensor,
             spatial_lr_scale, cameras_extent,
             sh_degree: int) -> StepOutput:
        return dp_step(state, opt, exposure, exposure_opt, [batch],
                       iteration, bg, spatial_lr_scale, cameras_extent,
                       sh_degree)

    return step


def densify_step(state: GaussianState, opt: adam_lib.AdamState,
                 generator: torch.Generator, max_grad: float,
                 min_opacity: float, extent, percent_dense: float,
                 eps: Optional[torch.Tensor] = None):
    """Densify + prune with the optimizer state of recycled slots reset.
    Returns (state, opt, (n_cloned, n_split, n_pruned, n_dropped))."""
    with torch.no_grad():
        res = densify_lib.densify_and_prune(
            state, generator, max_grad, min_opacity, extent, percent_dense,
            eps=eps)
        new_opt = adam_lib.reset_rows(opt, res.touched_rows)
    return res.state, new_opt, (res.n_cloned, res.n_split, res.n_pruned,
                                res.n_dropped)


def reset_opacity_step(state: GaussianState, opt: adam_lib.AdamState):
    """Opacity reset + zeroed opacity moments (gaussian_model.py:510-514)."""
    with torch.no_grad():
        new_state = densify_lib.reset_opacity(state)
        new_opt = adam_lib.reset_rows(
            opt, torch.ones(state.capacity, dtype=torch.bool,
                            device=state.device), keys=["opacity"])
    return new_state, new_opt
