"""Interactive hierarchy rendering service (PyTorch/CUDA).

Counterpart of ``h3dgs_tpu/viewer/service.py``: renders a merged
hierarchy at a target granularity tau, raising tau on a x1.5 ladder when
the view-adaptive cut would exceed a splat budget. Exposes:

  * HierarchyRenderer — tau-budgeted rendering of arbitrary cameras;
  * serve() — the network_gui TCP protocol loop;
  * orbit() — offline fly-through rendering to PNG frames.

Runs on the card unless ``device="cpu"`` is passed. Each request of
``serve()`` is the span ``serve.request`` (``serve.read``, the render,
``serve.send``; ``utils/profiling.py``). ``n_bands`` splits
each frame into pixel bands over that many visible cards
(``parallel/band_render.py``; 0 = every card, more than there are is cut
to what there is, so one card renders one band). ``--web_port`` serves
the browser viewer (``viewer/web.py``) instead of the socket protocol.

Run: python -m h3dgs_tpu_torch.viewer.service --hierarchy merged.hier
"""
from __future__ import annotations

import math
import os
import threading
import time
import traceback
from typing import Optional

import numpy as np
import torch

from ..hierarchy import cut as cut_lib
from ..hierarchy.io import read_hier
from ..io.image import write_png
from ..model.init import state_from_hierarchy
from ..ops.rasterize import RasterizeConfig
from ..parallel import sharding as shard_lib
from ..scene.camera import Camera, look_at_camera
from ..train.post_step import select_cut_gaussians, splat_cut_gaussians
from ..utils import profiling
from ..utils.runtime import resolve_device

# The reference viewer's MiB -> splat conversion (bytes one rendered splat
# costs in the JAX package's device layout), kept so ``--budget_mb`` names
# the same splat budget in both packages. It is not a measurement of the
# port's memory per splat.
BYTES_PER_SPLAT = 660

LADDER_STEPS = 16
LADDER_RATIO = 1.5


def splats_for_mb(mb: float) -> int:
    """Render-budget splat count for a device-memory budget in MiB."""
    return max(int(mb * (1 << 20) / BYTES_PER_SPLAT), 1 << 10)


class HierarchyRenderer:
    @torch.no_grad()
    def __init__(self, hierarchy_path: str, scaffold_dir: str = "",
                 sh_degree: int = 3, budget: int = 1 << 20,
                 raster_cfg: Optional[RasterizeConfig] = None,
                 white_background: bool = False, n_bands: int = 0,
                 reuse_margin: float = 0.05, device=None):
        self.device = resolve_device(device)
        # Pixel bands over the visible cards for single-frame latency
        # (n_bands=0: every card; 1: this device alone).
        avail = shard_lib.visible_devices(self.device.type)
        n_bands = len(avail) if n_bands == 0 else min(n_bands, len(avail))
        self.band_devices = (shard_lib.band_devices(n_bands, avail)
                             if n_bands > 1 else None)
        self.h = read_hier(hierarchy_path)
        self.state, _ = state_from_hierarchy(self.h, scaffold_dir,
                                             max_sh_degree=sh_degree,
                                             device=self.device)
        self.sh_degree = sh_degree
        self.nodes = torch.as_tensor(self.h.nodes, device=self.device)
        self.boxes = torch.as_tensor(self.h.boxes, device=self.device)
        self.budget = min(budget, self.h.n_nodes)
        self.raster_cfg = raster_cfg or RasterizeConfig()
        # Frame-to-frame cut reuse: the cut depends only on the camera
        # POSITION, so select with a (1 - margin) finer limit and reuse it
        # while the camera has moved less than margin * (distance to the
        # nearest cut node): every cached node's projected size then stays
        # <= the requested limit, i.e. the reused cut is never coarser
        # than a fresh selection. 0 disables.
        self.reuse_margin = reuse_margin
        self._cut_cache = None
        self.bg = torch.full((3,), 1.0 if white_background else 0.0,
                             dtype=torch.float32, device=self.device)
        # Cached fused interpolation table: the params are static, so
        # per-frame interpolation is two row gathers of it.
        self._table = cut_lib.interp_table(self.state.trainable_dict())

    def _d_min(self, cut: cut_lib.Cut, cam_center: torch.Tensor):
        """Min camera->node distance over the cut (the reuse bound)."""
        m = self.nodes.shape[0]
        b = self.boxes[cut.indices.long().clamp_max(m - 1)]
        delta = torch.clamp_min(torch.maximum(b[:, 0] - cam_center,
                                              cam_center - b[:, 1]), 0.0)
        dist = cut_lib.norm3(delta)
        return torch.where(cut.valid, dist,
                           torch.full_like(dist, float("inf"))).min()

    def _fit_limit(self, limit0: float, cam_center: torch.Tensor):
        """Budget fit on the tau ladder + hysteresis: the smallest ladder
        limit whose cut fits the budget (the last rung if none does), and
        the (1 - margin) finer limit to select with when that also fits.
        Returns (limit, selection limit, hysteresis ok)."""
        dev = self.device
        ladder = (torch.tensor(limit0, dtype=torch.float32, device=dev)
                  * (LADDER_RATIO ** torch.arange(LADDER_STEPS,
                                                  dtype=torch.float32,
                                                  device=dev)))
        counts = cut_lib.cut_counts(self.nodes, self.boxes, cam_center,
                                    ladder)
        fits = counts <= self.budget
        idx = torch.where(fits.any(), fits.to(torch.int32).argmax(),
                          torch.tensor(LADDER_STEPS - 1, device=dev))
        with profiling.span("serve.ladder.sync"):
            limit = ladder[idx]     # indexing by a device scalar reads it
        if self.reuse_margin <= 0:
            return limit, limit, torch.tensor(False, device=dev)
        hyst = limit * (1.0 - self.reuse_margin)
        count_h = cut_lib.cut_counts(self.nodes, self.boxes, cam_center,
                                     hyst[None])[0]
        hyst_ok = count_h <= self.budget
        return limit, torch.where(hyst_ok, hyst, limit), hyst_ok

    def _select_auto(self, limit0: float, cam_center: torch.Tensor):
        """Budget fit + selection + interpolation for a fresh frame; the
        cut's size comes back as the host int the selection read."""
        with profiling.span("serve.fit"):
            limit, sel_limit, hyst_ok = self._fit_limit(limit0, cam_center)
        xyz, scales, quats, opac, shs, cut = select_cut_gaussians(
            self.state, self.nodes, self.boxes, cam_center, sel_limit,
            max_cut=self.budget, table=self._table)
        return ((xyz, scales, quats, opac, shs), cut.size,
                self._d_min(cut, cam_center), limit, hyst_ok)

    def _splat(self, camera: Camera, xyz, scales, quats, opac, shs):
        out = splat_cut_gaussians(xyz, scales, quats, opac, shs,
                                  camera.to(self.device), self.sh_degree,
                                  self.bg, self.raster_cfg,
                                  band_devices=self.band_devices)
        # uint8 on the device (by truncation): the host copy is 4x smaller.
        # Made contiguous there: the JPEG encoder and the socket read the
        # frame in row order, and a strided host copy of a 1080p frame
        # costs them more than the frame's render.
        with profiling.span("serve.finish"):
            img = torch.clamp(out["render"], 0.0, 1.0)
            return (img.permute(1, 2, 0) * 255.0).to(
                torch.uint8).contiguous()

    def _cut_for(self, camera: Camera, tau: float):
        """Cached-or-fresh flat Gaussians for (camera position, tau)."""
        with profiling.span("serve.center.sync"):
            center = camera.cam_center.cpu().numpy().astype(np.float64)
        cache = self._cut_cache
        margin = self.reuse_margin
        if (cache is not None and cache["tau"] == tau
                and cache["hw"] == (camera.height, camera.width)
                and np.linalg.norm(center - cache["center"])
                < margin * cache["d_min"]):
            return cache["flat"], cache["count"], cache["limit"], True
        limit0 = cut_lib.pixel_limit(tau, float(camera.tanfovx),
                                     camera.width)
        flat, count, d_min, limit_dev, hyst_ok = self._select_auto(
            limit0, camera.cam_center.to(self.device))
        return (flat, count, (tau, center, camera, limit_dev, d_min,
                              hyst_ok), False)

    def _maybe_cache(self, flat, count, meta) -> float:
        """Populate the cut cache after the frame was fetched; returns the
        frame's limit. Each device value is read once, in a span of its
        own."""
        tau, center, camera, limit_dev, d_min, hyst_ok = meta
        with profiling.span("serve.limit.sync"):
            limit = float(limit_dev)
        if self.reuse_margin <= 0:
            return limit
        with profiling.span("serve.hyst.sync"):
            cacheable = bool(hyst_ok)
        if cacheable:
            with profiling.span("serve.dmin.sync"):
                d = float(d_min)
            # An empty cut yields d_min = inf, which would make the reuse
            # test vacuously true forever: never cache it.
            if np.isfinite(d):
                self._cut_cache = {"center": center, "tau": tau,
                                   "hw": (camera.height, camera.width),
                                   "limit": limit, "d_min": d,
                                   "flat": flat, "count": count}
        return limit

    @torch.no_grad()
    def render(self, camera: Camera, tau: float = 3.0):
        """Returns (rgb [H,W,3] uint8 numpy, stats dict).

        The span ``serve.render`` holds ``serve.cut`` (cache or
        ``serve.fit`` and ``cut.select``), the raster spans,
        ``serve.finish`` and ``serve.cache``; every host read of a device
        value on the way is a span whose name ends in ``.sync``
        (``utils/profiling.py``)."""
        with profiling.span("serve.render"):
            with profiling.span("serve.cut"):
                flat, count, limit, reused = self._cut_for(camera, tau)
            img = self._splat(camera, *flat)
            with profiling.span("serve.frame.sync"):
                img = img.cpu().numpy()
            if not reused:
                with profiling.span("serve.cache"):
                    limit = self._maybe_cache(flat, count, limit)
        return (img, {"cut_size": count, "limit": limit,
                      "cut_reused": reused})


def orbit(renderer: HierarchyRenderer, out_dir: str, n_frames: int = 60,
          radius: float = 50.0, height: float = -10.0,
          center=(0.0, 0.0, 0.0), tau: float = 6.0,
          width: int = 1200, height_px: int = 675) -> None:
    """Offline fly-through: circle the scene center, save PNG frames
    (the port's own PNG writer)."""
    os.makedirs(out_dir, exist_ok=True)
    for i, a in enumerate(np.linspace(0, 2 * math.pi, n_frames,
                                      endpoint=False)):
        eye = (center[0] + radius * math.sin(a), center[1] + height,
               center[2] - radius * math.cos(a))
        cam = look_at_camera(eye=eye, target=center, fovx=1.2,
                             width=width, height=height_px)
        img, stats = renderer.render(cam, tau)
        write_png(os.path.join(out_dir, f"frame_{i:04d}.png"), img)
        print(f"frame {i}: cut={stats['cut_size']}", flush=True)


def serve(renderer: HierarchyRenderer, ip: str = "127.0.0.1",
          port: int = 6009, tau: float = 3.0,
          stop: Optional[threading.Event] = None) -> None:
    """Serve the network_gui protocol on a merged hierarchy.

    Blocks until ``stop`` is set (forever when None). A client that hangs
    up is dropped quietly; a malformed message drops its connection with
    a traceback, and the service keeps serving.
    """
    from .network_gui import NetworkGUI

    gui = NetworkGUI(ip, port)
    print(f"hierarchy render service on {ip}:{port}", flush=True)
    try:
        while stop is None or not stop.is_set():
            if gui.conn is None:
                gui._try_connect()
                if gui.conn is None:
                    time.sleep(0.05)
                continue
            try:
                with profiling.span("serve.request", begins=True):
                    with profiling.span("serve.read"):
                        msg = gui._read_msg()
                        cam = gui._camera_from_msg(msg)
                    # The last frame's bytes go before this frame's render
                    # and its pixels after, so the frame's copy to the host
                    # can land in memory the process already holds: freeing
                    # both first made that copy of a 1080p frame take 3.0-
                    # 3.6 ms on an H100's host instead of 1.2-1.3.
                    payload = None
                    if cam is not None:
                        img, _ = renderer.render(cam, tau)
                    with profiling.span("serve.send"):
                        if cam is not None:
                            payload = memoryview(img.tobytes())
                        gui._send(payload)
            except ConnectionError:
                gui.conn.close()
                gui.conn = None
            except Exception:
                # Malformed message / version-mismatched client: drop the
                # connection, keep serving.
                traceback.print_exc()
                try:
                    gui.conn.close()
                except OSError:
                    pass
                gui.conn = None
    finally:
        gui.close()


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--hierarchy", required=True)
    p.add_argument("--scaffold_file", default="")
    p.add_argument("--budget", type=int, default=1 << 20,
                   help="max splats per frame (the viewer's VRAM budget)")
    p.add_argument("--budget_mb", type=float, default=0.0,
                   help="render budget in MiB, converted at the reference "
                        f"viewer's {BYTES_PER_SPLAT} B/splat (overrides "
                        "--budget)")
    p.add_argument("--tau", type=float, default=3.0)
    p.add_argument("--ip", default="127.0.0.1")
    p.add_argument("--port", type=int, default=6009)
    p.add_argument("--orbit_dir", default="",
                   help="render an offline orbit instead of serving")
    p.add_argument("--web_port", type=int, default=0,
                   help="serve the browser viewer on this port instead of "
                        "the network_gui protocol")
    p.add_argument("--n_frames", type=int, default=60)
    p.add_argument("--radius", type=float, default=50.0)
    p.add_argument("--width", type=int, default=1200)
    p.add_argument("--n_bands", type=int, default=0,
                   help="pixel bands across the visible cards (0 = all)")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without it)")
    a = p.parse_args(argv)
    budget = splats_for_mb(a.budget_mb) if a.budget_mb else a.budget
    r = HierarchyRenderer(a.hierarchy, a.scaffold_file, budget=budget,
                          n_bands=a.n_bands, device=a.device)
    if a.orbit_dir:
        orbit(r, a.orbit_dir, n_frames=a.n_frames, radius=a.radius,
              tau=a.tau, width=a.width,
              height_px=int(a.width * 9 / 16))
    elif a.web_port:
        from .web import WebViewer
        WebViewer(r, host=a.ip, port=a.web_port, tau=a.tau).serve_forever()
    else:
        serve(r, a.ip, a.port, a.tau)


if __name__ == "__main__":
    main()
