"""Host-side flat training loop (counterpart of
``h3dgs_tpu/train/loop.py:train_flat``).

Drives the train step (``train/step.py``) around a streaming view loader,
with densification and opacity reset on their intervals, capacity growth
when a densify pass runs out of slots, SH warm-up, the 50-iteration log
line and artifact saving. Single process, one device. The JAX loop's
adaptive entry and backward-truncation budgets are not carried over:
they size the TPU's static entry buffers, and the port allocates exact
entry counts. Checkpoints (``train/checkpoint.py``) and view data
parallelism are later slices.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import torch

from ..config import FullConfig
from ..model import state as state_lib
from ..ops import adam as adam_lib
from ..ops.rasterize import RasterizeConfig
from ..scene.scene import Scene
from .step import (batch_to_device, densify_step, encode_view,
                   make_train_step, reset_opacity_step)


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


class DevicePrefetcher:
    """Encode the NEXT view (uint8 / f16) and start its transfer to the
    device through pinned memory, one view ahead, while the current step
    computes."""

    def __init__(self, stream, device):
        self.stream = stream
        self.device = device
        self._next = self._launch()

    def _launch(self):
        host = next(self.stream)
        return host, batch_to_device(encode_view(host), self.device)

    def __next__(self):
        host, dev = self._next
        self._next = self._launch()
        return host, dev


@dataclasses.dataclass
class TrainLog:
    """Deferred-sync loss log: keeps device scalars between log points so
    the hot loop never waits on a readback, and folds them into the EMA
    there."""
    ema_photo: float = 0.0
    ema_depth: float = 0.0
    t_start: float = 0.0
    _pending: list = dataclasses.field(default_factory=list)

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
    Returns the final (state, exposure) on the scene's device.
    """
    if checkpoint_iterations or start_checkpoint:
        raise NotImplementedError(
            "checkpoints (train/checkpoint.py) are not ported yet")
    if cfg.runtime.data_devices > 1:
        raise NotImplementedError(
            "view data parallelism (data_devices > 1) is not ported yet")
    opt_cfg = cfg.opt
    r_cfg = raster_config(cfg)
    max_sh = 1 if coarse else cfg.model.sh_degree
    save_iterations = save_iterations or [opt_cfg.iterations]
    device = scene.device

    step = make_train_step(
        opt_cfg, r_cfg,
        use_depth_loss=not coarse,
        use_exposure=not coarse,
        skybox_locked=cfg.model.skybox_locked or coarse,
        freeze_xyz=coarse,
        shrink_threshold=0.1 if coarse else 0.02,
        shrink_protect_scaffold=True,
        skip_shrink=cfg.model.skip_scale_big_gauss)

    state = scene.state
    opt = adam_lib.init(state.trainable_dict())
    exposure = torch.as_tensor(scene.exposures, device=device)
    exp_opt = adam_lib.init({"exposure": exposure})

    bg = (torch.ones(3, device=device) if cfg.model.white_background
          else torch.zeros(3, device=device))
    extent = float(scene.cameras_extent)
    stream = scene.train_stream(num_workers=8)
    prefetch = DevicePrefetcher(stream, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    log = TrainLog(t_start=time.time())

    try:
        for it in range(1, opt_cfg.iterations + 1):
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
                    state, opt, stats = densify_step(
                        state, opt, gen, opt_cfg.densify_grad_threshold,
                        0.005, extent, opt_cfg.percent_dense)
                    n_clone, n_split, n_prune, n_drop = map(int, stats)
                    print(f"[{it}] densify: cloned {n_clone}, split "
                          f"{n_split}, pruned {n_prune}, dropped {n_drop}",
                          flush=True)
                    if n_drop > 0:
                        cap = state.capacity
                        want = _capacity_bucket(
                            cap, n_drop, cfg.runtime.max_capacity)
                        if cfg.runtime.grow_capacity and want > cap:
                            tail = (state.n_skybox if state.skybox_last
                                    else 0)
                            state = state_lib.grow_capacity(state, want)
                            opt = adam_lib.grow_rows(opt, want, tail)
                            print(f"[{it}] DENSIFY-DROP {n_drop}: "
                                  f"capacity {cap} -> {want}", flush=True)
                        else:
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
                rate = it / max(time.time() - log.t_start, 1e-9)
                print(f"[{it}/{opt_cfg.iterations}] "
                      f"loss={log.ema_photo:.5f} "
                      f"depth={log.ema_depth:.5f} "
                      f"alive={n_alive} it/s={rate:.2f}", flush=True)
            if it in save_iterations:
                path = scene.save(it, state, exposure.cpu().numpy())
                print(f"[{it}] saved -> {path}", flush=True)
    finally:
        stream.close()
    return state, exposure
