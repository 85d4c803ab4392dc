"""Host-side training loops (counterpart of ``h3dgs_tpu/train/loop.py``:
``train_flat`` and ``train_post``).

``train_flat`` drives the flat train step (``train/step.py``) around a
streaming view loader, with densification and opacity reset on their
intervals, capacity growth when a densify pass runs out of slots, SH
warm-up, the 50-iteration log line, artifact saving and checkpoints.
``train_post`` fine-tunes a hierarchy (``train/post_step.py``): a sampled
granularity per view, the pretrained exposure of the view, ``<hier>_opt``
on save. Both run the dp steps of ``parallel/step.py``, one view a step
unless ``runtime.views_per_step`` > 1, and share the views over the
processes of a ``torch.distributed`` group, one card each
(``runtime.data_devices`` > 1, ``parallel/multihost.py``): each process
loads only its own views of each step's window of the shared view
sequence, and only the primary process logs and writes artifacts.
The JAX loops' adaptive entry, backward-truncation and cut-capacity
budgets are not carried over: they size the TPU's static buffers, and the
port allocates exact entry counts and exact cuts.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..config import FullConfig
from ..model import state as state_lib
from ..ops import adam as adam_lib
from ..ops.rasterize import RasterizeConfig
from ..parallel import multihost as mh
from ..scene.scene import Scene
from ..scene.views import staged_to_device
from ..parallel import step as dp_lib
from ..utils import profiling
from . import checkpoint as ckpt_lib
from .post_step import sample_limit
from .step import densify_step, reset_opacity_step


def raster_config(cfg: FullConfig) -> RasterizeConfig:
    return RasterizeConfig(tile=cfg.runtime.tile)


def _capacity_bucket(cap: int, n_drop: int, max_cap: int) -> int:
    """Next capacity after a densify drop: at least 1.5x, covering the
    dropped items with headroom, rounded to a 1024 multiple."""
    need = max(int(cap * 1.5), cap + 4 * n_drop)
    need = -(-need // 1024) * 1024
    if max_cap > 0:
        need = min(need, max(max_cap, cap))
    return need


class BatchedPrefetcher:
    """Take this process's next ``batch_size`` views and start their
    transfer to the device, one step ahead, while the current step
    computes. Yields (host views, device views) as lists.

    ``stream`` yields ``StagedView``s (``ViewStream``, staged for
    ``device``): each view reaches the device as one ``non_blocking``
    copy of its record and is decoded there to float32
    (``views.staged_to_device``).

    ``__next__`` is the span ``view.next``, which begins a step's ordinal;
    inside it ``view.wait`` (blocked on the stream) and ``view.copy``
    (the copy and the decode). The counter ``view.ready`` adds 1 for each
    view the stream had already decoded, ``view.staged`` 1 for each
    view."""

    def __init__(self, stream, batch_size: int, device):
        self.stream = stream
        self.batch_size = batch_size
        self.device = device
        # ViewStream.ready; another iterator leaves the counter out.
        self._ready = getattr(stream, "ready", None)
        self._next = self._launch()

    def _launch(self):
        views, devs = [], []
        for _ in range(self.batch_size):
            if self._ready is not None:
                profiling.count("view.ready", int(self._ready()))
            with profiling.span("view.wait"):
                views.append(next(self.stream))
        for v in views:
            profiling.count("view.staged", 1)
            with profiling.span("view.copy"):
                devs.append(staged_to_device(v, self.device))
        return [v.host for v in views], devs

    def __next__(self):
        with profiling.span("view.next", begins=True):
            hosts, dev = self._next
            self._next = self._launch()
        return hosts, dev


@dataclasses.dataclass
class DpSetup:
    """The data-parallel wiring shared by ``train_flat`` and
    ``train_post`` (counterpart of the JAX loop's ``_DpSetup``).

    One view a step is the default (``local_views`` = 1); ``data_devices``
    = 1 with ``views_per_step`` > 1 accumulates several views a step on
    one card. With a process group, each process is one of the
    ``data_devices``: it loads only its own ``local_views`` of each
    ``views_per_step`` window of the shared-seed view sequence
    (``keep_fn``), and artifact writes happen on the primary only.
    """
    primary: bool
    process_index: int
    views_per_step: int
    local_views: int
    keep_fn: object


def dp_setup(cfg: FullConfig) -> DpSetup:
    n_data = max(cfg.runtime.data_devices, 1)
    views_per_step = cfg.runtime.views_per_step or n_data
    if views_per_step % n_data:
        raise ValueError(f"views_per_step ({views_per_step}) must be a "
                         f"multiple of data_devices ({n_data})")
    n_proc, pidx = mh.process_count(), mh.process_index()
    if views_per_step % n_proc:
        raise ValueError(f"views_per_step ({views_per_step}) must be a "
                         f"multiple of process_count ({n_proc})")
    if n_data != n_proc:
        raise ValueError(
            f"data_devices={n_data} must equal the size of the process "
            f"group ({n_proc}): one process per card (start them with the "
            f"H3DGS_* variables or torchrun)")
    local_views = views_per_step // n_proc
    keep_fn = None
    if n_proc > 1:
        keep_fn = (lambda pos, _v=views_per_step, _l=local_views,
                   _p=pidx: (pos % _v) // _l == _p)
    return DpSetup(primary=mh.is_primary(),
                   process_index=pidx, views_per_step=views_per_step,
                   local_views=local_views, keep_fn=keep_fn)


@dataclasses.dataclass
class TrainLog:
    """Deferred-sync loss log: keeps device scalars between log points so
    the hot loop never waits on a readback, and folds them into the EMA
    there. ``rate(it)`` is the iterations a second this run has made
    since it started at ``first_iter``."""
    first_iter: int = 0
    ema_photo: float = 0.0
    ema_depth: float = 0.0
    t_start: float = dataclasses.field(default_factory=time.perf_counter)
    _pending: list = dataclasses.field(default_factory=list)

    def rate(self, it: int) -> float:
        return (it - self.first_iter) / max(
            time.perf_counter() - self.t_start, 1e-9)

    def update(self, photo, depth):
        self._pending.append((photo, depth))
        if len(self._pending) > 64:
            del self._pending[:-8]  # keep the EMA window, drop stale refs

    def sync(self):
        for photo, depth in self._pending:
            self.ema_photo = 0.4 * float(photo) + 0.6 * self.ema_photo
            self.ema_depth = 0.4 * float(depth) + 0.6 * self.ema_depth
        self._pending.clear()


def train_flat(cfg: FullConfig, scene: Scene, coarse: bool = False,
               save_iterations: Optional[List[int]] = None,
               checkpoint_iterations: Optional[List[int]] = None,
               start_checkpoint: str = "",
               viewer=None, step_cb: Optional[Callable] = None):
    """Flat-model training: train_single (coarse=False) or train_coarse.

    Coarse variant: sh degree 1, frozen xyz, no depth loss / exposure step
    / densification, shrink threshold 0.1, a random background per step.
    ``step_cb(it, out)``: called after every step with its StepOutput.
    ``checkpoint_iterations`` write ``<model_path>/chkpnt<it>.npz``
    (``train/checkpoint.py``); ``start_checkpoint`` resumes from one at
    the iteration after its own. As in the reference, a checkpoint holds
    the state, both optimizers, the exposures and the iteration, not the
    view stream's position nor the ``torch.Generator``'s state: a resumed
    run walks the views from the start of their order and redraws its
    densification noise and coarse backgrounds.
    With several views a step (``DpSetup``), the StepOutput's losses are
    the means over the step's views.
    Returns the final (state, exposure) on the scene's device.
    """
    opt_cfg = cfg.opt
    r_cfg = raster_config(cfg)
    max_sh = 1 if coarse else cfg.model.sh_degree
    save_iterations = save_iterations or [opt_cfg.iterations]
    device = scene.device
    dp = dp_setup(cfg)
    primary = dp.primary

    step_kwargs = dict(
        use_depth_loss=not coarse,
        use_exposure=not coarse,
        skybox_locked=cfg.model.skybox_locked or coarse,
        freeze_xyz=coarse,
        shrink_threshold=0.1 if coarse else 0.02,
        shrink_protect_scaffold=True,
        skip_shrink=cfg.model.skip_scale_big_gauss)
    step = dp_lib.make_dp_train_step(opt_cfg, r_cfg, **step_kwargs)

    state = scene.state
    opt = adam_lib.init(state.trainable_dict())
    exposure = torch.as_tensor(scene.exposures, device=device)
    exp_opt = adam_lib.init({"exposure": exposure})
    first_iter = 0
    if start_checkpoint:
        state, opt, exposure, exp_opt, first_iter = ckpt_lib.load_flat(
            start_checkpoint, state)
        print(f"restored checkpoint at iteration {first_iter}")

    bg = (torch.ones(3, device=device) if cfg.model.white_background
          else torch.zeros(3, device=device))
    extent = float(scene.cameras_extent)
    stream = scene.train_stream(num_workers=8, keep_fn=dp.keep_fn)
    prefetch = BatchedPrefetcher(stream, dp.local_views, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    log = TrainLog(first_iter)

    try:
        for it in range(first_iter + 1, opt_cfg.iterations + 1):
            if viewer is not None:
                viewer.poll(state, max_sh, r_cfg, bg)
            _, batch = next(prefetch)
            sh_deg = min(it // 1000, max_sh)
            if coarse:
                bg_it = torch.rand(3, generator=gen, device=device)
            else:
                bg_it = bg
            out = step(state, opt, exposure, exp_opt, batch, it, bg_it,
                       extent, extent, sh_deg)
            state, opt = out.state, out.opt
            exposure, exp_opt = out.exposure, out.exposure_opt
            log.update(out.photo_loss, out.depth_loss)
            if step_cb is not None:
                step_cb(it, out)

            if not coarse and it < opt_cfg.densify_until_iter:
                if (it > opt_cfg.densify_from_iter
                        and it % opt_cfg.densification_interval == 0):
                    with profiling.span("train.densify"):
                        state, opt, stats = densify_step(
                            state, opt, gen, opt_cfg.densify_grad_threshold,
                            0.005, extent, opt_cfg.percent_dense)
                        n_clone, n_split, n_prune, n_drop = map(int, stats)
                    if primary:
                        print(f"[{it}] densify: cloned {n_clone}, split "
                              f"{n_split}, pruned {n_prune}, dropped "
                              f"{n_drop}", flush=True)
                    if n_drop > 0:
                        cap = state.capacity
                        want = _capacity_bucket(
                            cap, n_drop, cfg.runtime.max_capacity)
                        if cfg.runtime.grow_capacity and want > cap:
                            tail = (state.n_skybox if state.skybox_last
                                    else 0)
                            state = state_lib.grow_capacity(state, want)
                            opt = adam_lib.grow_rows(opt, want, tail)
                            if primary:
                                print(f"[{it}] DENSIFY-DROP {n_drop}: "
                                      f"capacity {cap} -> {want}",
                                      flush=True)
                        elif primary:
                            print(f"[{it}] DENSIFY-DROP {n_drop} "
                                  f"(capacity {cap} full; growth "
                                  f"disabled or at max_capacity)",
                                  flush=True)
                if it % opt_cfg.opacity_reset_interval == 0 or (
                        cfg.model.white_background
                        and it == opt_cfg.densify_from_iter):
                    state, opt = reset_opacity_step(state, opt)

            if it % 50 == 0 or it == opt_cfg.iterations:
                log.sync()
                n_alive = int(state.n_alive)
                profiling.count("train.alive_rows", n_alive)
                profiling.count("train.capacity_rows", state.capacity)
                profiling.count("train.step_rows", state.high_water)
                if primary:
                    print(f"[{it}/{opt_cfg.iterations}] "
                          f"loss={log.ema_photo:.5f} "
                          f"depth={log.ema_depth:.5f} "
                          f"alive={n_alive} it/s={log.rate(it):.2f}",
                          flush=True)
            if it in save_iterations and primary:
                path = scene.save(it, state, exposure.cpu().numpy())
                print(f"[{it}] saved -> {path}", flush=True)
            if checkpoint_iterations and it in checkpoint_iterations \
                    and primary:
                ckpt_lib.save_flat(
                    os.path.join(scene.model_path, f"chkpnt{it}.npz"),
                    state, opt, exposure, exp_opt, it)
    finally:
        stream.close()
    return state, exposure


def train_post(cfg: FullConfig, scene: Scene,
               save_iterations: Optional[List[int]] = None,
               checkpoint_iterations: Optional[List[int]] = None,
               start_checkpoint: str = "",
               step_cb: Optional[Callable] = None):
    """Hierarchy fine-tune over a ``Scene(create_from_hier=True)``.

    Per step: a log-uniform granularity limit, the view's pretrained
    exposure row (identity when ``exposure.json`` lacks the view), SH
    degree ``min(it // 1000, max_sh)``, one post step. Every 50
    iterations a log line with the last step's cut size; on
    ``save_iterations`` ``scene.save(..., hierarchy=)`` writes
    ``<hier>_opt``; checkpoints hold a zero exposure and a fresh exposure
    optimizer (post-training has none). A run resumed from a checkpoint
    seeds its view order and its limits with the checkpoint's iteration,
    so it does not repeat the (view, limit) pairs the first run began
    with.

    The reference sizes the cut to a power-of-two bucket (``max_cut``,
    its ``initial_max_cut`` argument) that it regrows after a step has
    rendered a truncated cut, because its compiled step needs static
    shapes. The port's step sizes every cut exactly, so no cut is ever
    truncated and there is no bucket to start or to grow:
    ``initial_max_cut`` has no counterpart.
    ``step_cb(it, out)``: called after every step with its
    PostStepOutput. With several views a step (``DpSetup``) each view
    gets its own limit and exposure row: the step draws one limit per
    view of the whole window from the shared generator, and each process
    takes its own views' limits, so a run on several processes draws the
    limits of the same run on one. Returns the final state on the
    scene's device.
    """
    opt_cfg = cfg.opt
    r_cfg = raster_config(cfg)
    h = scene.hierarchy
    if h is None:
        raise ValueError("train_post requires --hierarchy "
                         "(Scene(create_from_hier=True))")
    save_iterations = save_iterations or [opt_cfg.iterations]
    max_sh = cfg.model.sh_degree
    device = scene.device

    dp = dp_setup(cfg)
    primary = dp.primary
    step_kwargs = dict(skybox_locked=cfg.model.skybox_locked,
                       use_exposure=scene.pretrained_exposures is not None)
    step = dp_lib.make_dp_post_step(opt_cfg, r_cfg, **step_kwargs)

    state = scene.state
    opt = adam_lib.init(state.trainable_dict())
    first_iter = 0
    if start_checkpoint:
        state, opt, _exp, _eo, first_iter = ckpt_lib.load_flat(
            start_checkpoint, state)
        print(f"restored checkpoint at iteration {first_iter}")
    nodes = torch.as_tensor(h.nodes, device=device)
    boxes = torch.as_tensor(h.boxes, device=device)
    amask = torch.as_tensor(scene.anchor_mask, device=device)
    bg = (torch.ones(3, device=device) if cfg.model.white_background
          else torch.zeros(3, device=device))
    spatial_lr = float(scene.cameras_extent)
    stream = scene.train_stream(seed=first_iter, num_workers=8,
                                keep_fn=dp.keep_fn)
    prefetch = BatchedPrefetcher(stream, dp.local_views, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(first_iter)
    log = TrainLog(first_iter)
    pre_exp = scene.pretrained_exposures or {}
    identity = np.eye(3, 4, dtype=np.float32)

    def exp_for(host_view):
        name = scene.image_names[int(host_view.image_idx)]
        return torch.as_tensor(
            np.asarray(pre_exp.get(name, identity), np.float32),
            device=device)

    own = slice(dp.process_index * dp.local_views,
                (dp.process_index + 1) * dp.local_views)
    try:
        for it in range(first_iter + 1, opt_cfg.iterations + 1):
            batch_host, batch = next(prefetch)
            sh_deg = min(it // 1000, max_sh)
            limits = [sample_limit(gen)
                      for _ in range(dp.views_per_step)][own]
            out = step(state, opt, batch, nodes, boxes, amask,
                       [exp_for(v) for v in batch_host], limits, it, bg,
                       spatial_lr, sh_deg)
            state, opt = out.state, out.opt
            log.update(out.photo_loss, 0.0)
            if step_cb is not None:
                step_cb(it, out)
            if (it % 50 == 0 or it == opt_cfg.iterations) and primary:
                log.sync()
                print(f"[{it}/{opt_cfg.iterations}] "
                      f"loss={log.ema_photo:.5f} cut={int(out.cut_size)} "
                      f"it/s={log.rate(it):.2f}", flush=True)
            if it in save_iterations and primary:
                path = scene.save(it, state, hierarchy=h)
                print(f"[{it}] saved -> {path}", flush=True)
            if checkpoint_iterations and it in checkpoint_iterations \
                    and primary:
                zero_exp = torch.zeros((1, 3, 4), device=device)
                ckpt_lib.save_flat(
                    os.path.join(scene.model_path, f"chkpnt{it}.npz"),
                    state, opt, zero_exp,
                    adam_lib.init({"exposure": zero_exp}), it)
    finally:
        stream.close()
    return state
