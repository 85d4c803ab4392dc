"""Data-parallel training steps: several views a step, on one card or
across the processes of a ``torch.distributed`` group (counterpart of
``h3dgs_tpu/parallel/step.py``).

``make_dp_train_step`` (flat training) and ``make_dp_post_step``
(hierarchy post-training) run the port's single-view render and loss over
this process's local views one after another (K1 forward, K3 when the
fused loss is on, K2 backward), sum the gradients, divide them by the
*global* view count and all-reduce them (SUM) over the group when there
is one; ``radii`` and ``visible`` reduce by MAX. The update then runs
once a step (``make_update`` / ``make_post_update`` of
``train/step.py`` / ``train/post_step.py``): locking, densification stats
from the batch-mean screen-space gradient, sparse Adam on the rows with a
nonzero opacity gradient in any view (H8), exposure Adam, shrink; the
post step's dense Adam with anchors and sky locked. These are the port's
only train steps: the single-view ``make_train_step`` and
``make_post_train_step`` pass their one view through them, and with one
view and no group nothing is divided or reduced.

The JAX package also has ``make_parallel_train_step``, a vmapped SPMD
step over a batched renderer that computes the same update as its
``make_dp_train_step``. The port has one dp step, held against both JAX
builders in its tests.

The flat step runs on the rows below the store's high-water mark
(``GaussianState.high_water``): every row above it is dead, so its
opacity is zero, projection culls it and the update leaves it as it is.
The step takes views of the first rows of the state and of Adam's moments
once, at entry, and at exit builds each output tensor as the updated rows
followed by the untouched rest, so ``StepOutput`` keeps the store's
capacity and the step never writes into its inputs. A store whose last
row is alive runs on all its rows.

The spans ``train.step`` / ``post.step`` hold a whole step and
``train.update`` / ``post.update`` its update (``utils/profiling.py``).

Memory: the gradient accumulator is one extra copy of the parameters'
gradients (59 floats a row below the mark).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..config import OptimizationConfig
from ..model.state import ALL_FIELDS, GaussianState
from ..ops import adam as adam_lib
from ..ops.rasterize import RasterizeConfig
from ..scene.views import ViewBatch
from ..train.post_step import (PostStepOutput, make_post_update,
                               make_post_view_grads)
from ..train.step import StepOutput, make_update, make_view_grads
from ..utils import profiling


def _group_size(group) -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


def _all_reduce(tensors: Sequence[torch.Tensor], op, group) -> None:
    for t in tensors:
        dist.all_reduce(t, op=op, group=group)


def _accumulate(acc: Optional[dict], grads: dict) -> dict:
    """Sum ``grads`` into ``acc`` in place (the first view's gradients
    become the accumulator, so one view needs no addition)."""
    if acc is None:
        return dict(grads)
    for k, g in grads.items():
        acc[k].add_(g)
    return acc


def _opt_prefix(opt: adam_lib.AdamState, rows: int) -> adam_lib.AdamState:
    return adam_lib.AdamState(mu={k: v[:rows] for k, v in opt.mu.items()},
                              nu={k: v[:rows] for k, v in opt.nu.items()},
                              step=opt.step)


def _write_back(full: torch.Tensor, part: torch.Tensor,
                out: torch.Tensor) -> torch.Tensor:
    """``full`` with its first rows replaced by ``out``, the step's result
    for the view ``part`` of them: a new tensor, or ``full`` itself when
    the step left ``part`` as it was."""
    return full if out is part else torch.cat([out, full[out.shape[0]:]])


def _write_back_state(full: GaussianState, part: GaussianState,
                      out: GaussianState) -> GaussianState:
    if part is full:
        return out
    return dataclasses.replace(
        out, **{k: _write_back(getattr(full, k), getattr(part, k),
                               getattr(out, k)) for k in ALL_FIELDS})


def _write_back_opt(full: adam_lib.AdamState, part: adam_lib.AdamState,
                    out: adam_lib.AdamState) -> adam_lib.AdamState:
    if part is full:
        return out
    return adam_lib.AdamState(
        mu={k: _write_back(full.mu[k], part.mu[k], v)
            for k, v in out.mu.items()},
        nu={k: _write_back(full.nu[k], part.nu[k], v)
            for k, v in out.nu.items()}, step=out.step)


def make_dp_train_step(opt_cfg: OptimizationConfig,
                       raster_cfg: RasterizeConfig,
                       use_depth_loss: bool = True,
                       use_exposure: bool = True,
                       skybox_locked: bool = True,
                       freeze_xyz: bool = False,
                       shrink_threshold: float = 0.02,
                       shrink_protect_scaffold: bool = True,
                       skip_shrink: bool = False, group=None):
    """Build the dp flat step. ``step(..., batch, ...)`` takes this
    process's views as a list of ``ViewBatch``; every process of ``group``
    (the default group when ``torch.distributed`` is initialised) must
    pass as many."""
    view_grads = make_view_grads(opt_cfg, raster_cfg, use_depth_loss,
                                 use_exposure)
    update = make_update(opt_cfg, use_exposure, skybox_locked, freeze_xyz,
                         shrink_threshold, shrink_protect_scaffold,
                         skip_shrink)

    def step(state: GaussianState, opt: adam_lib.AdamState,
             exposure: torch.Tensor, exposure_opt: adam_lib.AdamState,
             batch: List[ViewBatch], iteration, bg: torch.Tensor,
             spatial_lr_scale, cameras_extent,
             sh_degree: int) -> StepOutput:
        with profiling.span("train.step"):
            n_proc = _group_size(group)
            n_total = len(batch) * n_proc
            part = state.prefix(state.high_water)
            part_opt = (opt if part is state
                        else _opt_prefix(opt, part.capacity))
            acc = g_exp = radii = visible = None
            photo = depth = n_dup = None
            for view in batch:
                g = view_grads(part, exposure, view, iteration, bg,
                               sh_degree)
                with torch.no_grad():
                    grads = dict(g.g_params, _offset=g.g_offset)
                    acc = _accumulate(acc, grads)
                    if use_exposure:
                        if g_exp is None:
                            g_exp = torch.zeros_like(exposure)
                        g_exp[view.image_idx] += g.g_exposure
                    if radii is None:
                        radii, visible = g.radii, g.visible
                        photo, depth = g.photo_loss, g.depth_loss
                        n_dup = g.n_duplicates
                    else:
                        radii = torch.maximum(radii, g.radii)
                        visible = visible | g.visible
                        photo = photo + g.photo_loss
                        depth = depth + g.depth_loss
                        n_dup = torch.maximum(n_dup, g.n_duplicates)
                del g, grads
            with torch.no_grad():
                if n_total > 1:
                    for v in acc.values():
                        v.div_(n_total)
                    if g_exp is not None:
                        g_exp.div_(n_total)
                if n_proc > 1:
                    floats = list(acc.values())
                    if g_exp is not None:
                        floats.append(g_exp)
                    losses = torch.stack([photo, depth])
                    _all_reduce(floats + [losses], dist.ReduceOp.SUM, group)
                    vis = visible.to(torch.int32)
                    n_dup = n_dup.to(torch.int32).reshape(1)
                    _all_reduce([radii, vis, n_dup], dist.ReduceOp.MAX, group)
                    visible, n_dup = vis > 0, n_dup[0]
                    photo, depth = losses[0], losses[1]
                g_offset = acc.pop("_offset")
            with profiling.span("train.update"):
                new_part, new_opt, exposure, exposure_opt = update(
                    part, part_opt, exposure, exposure_opt, acc, g_exp,
                    g_offset, radii, visible, iteration, spatial_lr_scale,
                    cameras_extent)
                new_state = _write_back_state(state, part, new_part)
                new_opt = _write_back_opt(opt, part_opt, new_opt)
            return StepOutput(
                state=new_state, opt=new_opt, exposure=exposure,
                exposure_opt=exposure_opt, photo_loss=photo / n_total,
                depth_loss=depth / n_total, n_visible=visible.sum(),
                n_duplicates=n_dup)

    return step


def make_dp_post_step(opt_cfg: OptimizationConfig,
                      raster_cfg: RasterizeConfig,
                      skybox_locked: bool = True,
                      use_exposure: bool = True, group=None):
    """Build the dp post step. ``step(..., batch, ..., exposure_rows,
    limits, ...)`` takes this process's views as a list of ``ViewBatch``
    with one pretrained exposure row ``[3, 4]`` and one granularity limit
    each; each view's cut is sized exactly (H11). ``cut_size`` is the
    largest cut over the views of every process, ``n_visible`` the largest
    count of visible rendered rows."""
    view_grads = make_post_view_grads(opt_cfg, raster_cfg, use_exposure)
    update = make_post_update(opt_cfg, skybox_locked)

    def step(state: GaussianState, opt: adam_lib.AdamState,
             batch: List[ViewBatch], nodes: torch.Tensor,
             boxes: torch.Tensor, anchor_mask: torch.Tensor,
             exposure_rows, limits, iteration, bg: torch.Tensor,
             spatial_lr_scale, sh_degree: int) -> PostStepOutput:
        with profiling.span("post.step"):
            n_proc = _group_size(group)
            n_total = len(batch) * n_proc
            acc = photo = cut_max = vis_max = None
            for view, exp_row, limit in zip(batch, exposure_rows, limits):
                g = view_grads(state, view, nodes, boxes, exp_row, limit, bg,
                               sh_degree)
                with torch.no_grad():
                    acc = _accumulate(acc, g.g_params)
                    if photo is None:
                        photo, cut_max, vis_max = (g.photo_loss, g.cut_size,
                                                   g.n_visible)
                    else:
                        photo = photo + g.photo_loss
                        cut_max = torch.maximum(cut_max, g.cut_size)
                        vis_max = torch.maximum(vis_max, g.n_visible)
                del g
            with torch.no_grad():
                if n_total > 1:
                    for v in acc.values():
                        v.div_(n_total)
                if n_proc > 1:
                    photo = photo.reshape(1).clone()
                    _all_reduce(list(acc.values()) + [photo],
                                dist.ReduceOp.SUM, group)
                    counts = torch.stack([cut_max.to(torch.int64),
                                          vis_max.to(torch.int64)])
                    _all_reduce([counts], dist.ReduceOp.MAX, group)
                    photo, cut_max, vis_max = photo[0], counts[0], counts[1]
            with profiling.span("post.update"):
                new_state, new_opt = update(state, opt, acc, anchor_mask,
                                            iteration, spatial_lr_scale)
            return PostStepOutput(
                state=new_state, opt=new_opt, photo_loss=photo / n_total,
                cut_size=cut_max, n_visible=vis_max)

    return step
