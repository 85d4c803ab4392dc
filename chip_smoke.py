#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port's serving path.

Drives ``h3dgs_tpu_torch`` end to end on one NVIDIA GPU at the viewer's
real size: a seeded synthetic hierarchy of 1,000,000 leaves (the wavy
surface of ``scripts/bench_render.py``, SH degree 3), opened with
``HierarchyRenderer(budget=1 << 20)`` and rendered at 1920x1080 on a
16-camera orbit for tau in {0, 3, 6, 15}, fresh-cut and cached-cut frames,
then served over the network_gui wire protocol by ``serve()``.

Phases, each failing the run with its traceback:
  1. card name and power limit (nvidia-smi); fails without CUDA;
  2. build every kernel from ``h3dgs_tpu_torch/csrc`` (one nvcc each,
     started together);
  3. build and write the hierarchy, open the renderer;
  4. the main path, with launch counts reset just before and read just
     after: renderer frames for every tau, then 3 socket requests through
     ``serve()`` whose replies are checked against ``renderer.render``;
  5. per-stage times with CUDA events (select, interpolate, project, bin,
     blend kernel, total) at each tau;
  6. each kernel against its plain PyTorch version on one frame's inputs,
     with times and the kernel's bound.
The line before last is one JSON object with each kernel's numbers; the
last line is the contract's ``{"ok": true, "device": ...}``.

Run: python3 chip_smoke.py   (from the repository root, on a machine with
one CUDA card; about 2-4 minutes, most of it the host-side hierarchy
build)
"""
from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

N_LEAVES = 1_000_000
WIDTH, HEIGHT = 1920, 1080
TAUS = (0.0, 3.0, 6.0, 15.0)
N_CAMS = 16
BUDGET = 1 << 20
SERVE_TAU = 3.0
N_SERVE = 3

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Blend: ~20 FP32 operations (one expf) per evaluated (entry, pixel) pair.
BLEND_OPS_PER_PAIR = 20
# Blend tolerance against the plain version: float32 rounding (expf,
# summation order) moves values by ~1e-7; a pixel whose termination test
# T(1 - alpha) < 1e-4 flips within rounding changes by at most one entry's
# contribution at T ~ 1e-4 (scaled by its color / inverse depth).
BLEND_TOL = 1e-4
BLEND_TOL_FLIPPED = 1e-3
BLEND_MAX_FLIPPED_FRAC = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def make_scene(rng):
    """The bench_render wavy surface: leaf spacing ~0.006 world units, so
    interior nodes merge neighbouring splats and tau moves the cut."""
    from h3dgs_tpu_torch.utils.sh import rgb_to_sh
    n = N_LEAVES
    uv = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    zs = (0.4 * np.sin(uv[:, 0] * 2.1) * np.cos(uv[:, 1] * 1.7)
          + 0.02 * rng.normal(size=n)).astype(np.float32)
    xyz = np.stack([uv[:, 0], zs, uv[:, 1]], axis=1)
    shs = np.zeros((n, 16, 3), np.float32)
    shs[:, 0] = rgb_to_sh(rng.uniform(0.1, 0.9, (n, 3)))
    # Nonzero rest coefficients: the view-dependent path does real work.
    shs[:, 1:] = rng.normal(0.0, 0.05, (n, 15, 3))
    alpha = rng.uniform(0.3, 0.95, n).astype(np.float32)
    scaling = rng.uniform(np.log(0.004), np.log(0.009), (n, 3)).astype(
        np.float32)
    rotation = rng.normal(size=(n, 4)).astype(np.float32)
    rotation /= np.linalg.norm(rotation, axis=1, keepdims=True)
    return xyz, shs, alpha, scaling, rotation


def orbit_cams(look_at_camera, target=(0.0, 0.0, 0.0)):
    return [look_at_camera(eye=(6 * np.sin(a), -1.0, -6 * np.cos(a)),
                           target=target, fovx=1.2, width=WIDTH,
                           height=HEIGHT)
            for a in np.linspace(0, 2 * np.pi, N_CAMS, endpoint=False)]


def client_message(cam) -> bytes:
    """network_gui request body for a column-vector camera: the wire carries
    transposed matrices with Y/Z (view) and Y (proj) columns negated."""
    view = cam.view.cpu().numpy().T.copy()
    view[:, 1] = -view[:, 1]
    view[:, 2] = -view[:, 2]
    proj = cam.full_proj.cpu().numpy().T.copy()
    proj[:, 1] = -proj[:, 1]
    msg = {
        "resolution_x": cam.width, "resolution_y": cam.height,
        "train": True,
        "fov_y": 2.0 * math.atan(float(cam.tanfovy)),
        "fov_x": 2.0 * math.atan(float(cam.tanfovx)),
        "z_near": 0.01, "z_far": 100.0, "shs_python": False,
        "rot_scale_python": False, "keep_alive": False,
        "scaling_modifier": 1.0,
        "view_matrix": view.reshape(-1).tolist(),
        "view_projection_matrix": proj.reshape(-1).tolist(),
    }
    return json.dumps(msg).encode("utf-8")


def recv_exact(s: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = s.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError(f"server closed after {len(buf)}/{n} B")
        buf += chunk
    return bytes(buf)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main_path(renderer, cams, look_at_camera, serve):
    """Frames for every tau (fresh and cached cuts), then socket requests
    through serve(). Returns (frames rendered, served cameras and
    replies)."""
    from h3dgs_tpu_torch.viewer.network_gui import NetworkGUI

    frames = 0
    for tau in TAUS:
        # Warm this tau at the last orbit position; the orbit then starts
        # at another position, so its first frame selects a fresh cut.
        renderer.render(cams[-1], tau)
        frames += 1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sizes = []
        for cam in cams:
            _, st = renderer.render(cam, tau)
            assert not st["cut_reused"], ("orbit step reused a cut", st)
            sizes.append(st["cut_size"])
        fresh = (time.perf_counter() - t0) / len(cams) * 1e3
        frames += len(cams)
        # Cached cut: same position as the last orbit camera, turned.
        eye = cams[-1].cam_center.cpu().numpy()
        turned = [look_at_camera(eye=eye, target=(0.3 * np.sin(a), 0.0,
                                                  0.3 * np.cos(a)),
                                 fovx=1.2, width=WIDTH, height=HEIGHT)
                  for a in np.linspace(0, 2 * np.pi, N_CAMS,
                                       endpoint=False)]
        t0 = time.perf_counter()
        for cam in turned:
            _, st = renderer.render(cam, tau)
            assert st["cut_reused"], ("turned camera re-selected", st)
        cached = (time.perf_counter() - t0) / len(turned) * 1e3
        frames += len(turned)
        log(f"main path tau={tau:4.1f}: fresh-cut frame {fresh:.3f} ms, "
            f"cached-cut frame {cached:.3f} ms (host clock, frame fetched "
            f"to host), mean cut {int(np.mean(sizes))}")

    port = free_port()
    stop = threading.Event()
    server = threading.Thread(target=serve, args=(renderer, "127.0.0.1",
                                                  port, SERVE_TAU),
                              kwargs={"stop": stop}, daemon=True)
    server.start()
    served = []
    deadline = time.time() + 30
    while True:
        try:
            client = socket.create_connection(("127.0.0.1", port),
                                              timeout=120)
            break
        except ConnectionRefusedError:
            if time.time() > deadline:
                raise
            time.sleep(0.05)
    with client:
        for cam in cams[::max(1, len(cams) // N_SERVE)][:N_SERVE]:
            t0 = time.perf_counter()
            msg = client_message(cam)
            client.sendall(len(msg).to_bytes(4, "little") + msg)
            # Compare with the camera as the server decodes it.
            cam = NetworkGUI._camera_from_msg(json.loads(msg))
            img = recv_exact(client, cam.height * cam.width * 3)
            vlen = int.from_bytes(recv_exact(client, 4), "little")
            verify = recv_exact(client, vlen).decode("ascii")
            served.append((cam, img, verify))
            log(f"serve request: {len(img)} B frame + verify {verify!r} in "
                f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    frames += len(served)
    assert len(served) == N_SERVE, len(served)
    stop.set()
    server.join(timeout=30)
    assert not server.is_alive(), "serve() did not stop"
    return frames, served


def stage_times(renderer, cams, tau):
    """Per-stage device times (CUDA events) of a fresh frame, averaged over
    the orbit, following HierarchyRenderer's own steps."""
    from h3dgs_tpu_torch.hierarchy import cut as cut_lib
    from h3dgs_tpu_torch.ops.binning import bin_gaussians
    from h3dgs_tpu_torch.ops.blend import blend_forward
    from h3dgs_tpu_torch.ops.projection import project_gaussians
    from h3dgs_tpu_torch.ops.rasterize import blend_args

    names = ("select", "interpolate", "project", "bin", "blend", "finish")
    acc = dict.fromkeys(names + ("total",), 0.0)
    counts = []
    last_inputs = None
    for cam in cams:
        cam = cam.to(renderer.device)
        ev = [torch.cuda.Event(enable_timing=True) for _ in names + ("",)]
        ev[0].record()
        center = cam.cam_center
        limit0 = cut_lib.pixel_limit(tau, float(cam.tanfovx), cam.width)
        _, sel, _ = renderer._fit_limit(limit0, center)
        cut = cut_lib.expand_to_size(renderer.nodes, renderer.boxes, sel,
                                     center, renderer.budget)
        ev[1].record()
        xyz, scales, quats, opac, shs = cut_lib.interpolate_cut(
            renderer.state.trainable_dict(), cut, renderer._table)
        ev[2].record()
        proj = project_gaussians(xyz, scales, quats, opac, shs, cam, 3)
        ev[3].record()
        binned = bin_gaussians(proj, cam.height, cam.width)
        ev[4].record()
        args = blend_args(proj, binned)
        color, _, final_t, _ = blend_forward(*args, cam.height, cam.width)
        ev[5].record()
        img = torch.clamp(color + final_t[None] * renderer.bg[:, None, None],
                          0.0, 1.0)
        img = (img.permute(1, 2, 0) * 255.0).to(torch.uint8).cpu()
        ev[6].record()
        torch.cuda.synchronize()
        for i, name in enumerate(names):
            acc[name] += ev[i].elapsed_time(ev[i + 1]) / len(cams)
        acc["total"] += ev[0].elapsed_time(ev[6]) / len(cams)
        counts.append((int(cut.count), int(binned.total_entries),
                       int(binned.tile_count.max())))
        last_inputs = (args, cam.height, cam.width)
    return acc, counts, last_inputs


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_blend(args, height, width, launches):
    """K1 against blend_plain on one frame's binned inputs."""
    from h3dgs_tpu_torch.ops.blend import blend_forward, blend_plain

    kern = blend_forward(*args, height, width)
    torch.cuda.synchronize()
    plain = blend_plain(*args, height, width, count_evaluated=True)
    torch.cuda.synchronize()
    diffs = torch.stack([(kern[0] - plain[0]).abs().amax(dim=0),
                         (kern[1] - plain[1]).abs()[0],
                         (kern[2] - plain[2]).abs()]).amax(dim=0)  # [H, W]
    max_err = float(diffs.max())
    flipped = float((diffs > BLEND_TOL).float().mean())
    last_eq = float((kern[3] == plain[3]).float().mean())
    log(f"blend_fwd vs blend_plain: max |d| {max_err:.3e} (tolerance "
        f"{BLEND_TOL:g} on all but {BLEND_MAX_FLIPPED_FRAC:g} of pixels, "
        f"{BLEND_TOL_FLIPPED:g} on those); pixels over {BLEND_TOL:g}: "
        f"{flipped:.3e}; last-entry index equal on {last_eq:.6f}")
    assert flipped <= BLEND_MAX_FLIPPED_FRAC, flipped
    assert max_err <= BLEND_TOL_FLIPPED, max_err
    assert last_eq >= 1.0 - BLEND_MAX_FLIPPED_FRAC, last_eq

    ms = time_ms(lambda: blend_forward(*args, height, width), 20)
    plain_ms = time_ms(lambda: blend_plain(*args, height, width), 2)

    # Bound: evaluated (entry, pixel) pairs of this data (each pixel up to
    # and including the entry that ends it) x ops, against bytes moved
    # once: referenced Gaussians (means2d 8, conic 12, rgb 12, opacity 4,
    # inverse depth 4 = 40 B), entry indices (4 B), tile ranges (8 B), and
    # 24 B written per pixel (color 12, inverse depth 4, T 4, last 4).
    means2d, _, _, _, _, gauss_idx, tile_start, _ = args
    pairs = int(plain[4].sum())
    n_ref = int(torch.unique(gauss_idx).numel())
    n_bytes = (40 * n_ref + 4 * gauss_idx.numel() + 8 * tile_start.numel()
               + 24 * height * width)
    t_ops = BLEND_OPS_PER_PAIR * pairs / PEAK_FP32_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    log(f"blend_fwd at {width}x{height}: {gauss_idx.numel()} entries, "
        f"{n_ref} Gaussians referenced, {pairs} evaluated pairs; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.3f} ms; bound {max(t_ops, t_bytes):.4f}"
        f" ms (operations {t_ops:.4f}, bytes {t_bytes:.4f})")
    return {"name": "blend_fwd", "route": "cuda",
            "source": "h3dgs_tpu_torch/csrc/blend_fwd.cu",
            "replaces": "h3dgs_tpu/ops/pallas_blend.py:430",
            "launches": launches, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    log(card_line())
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from h3dgs_tpu_torch.hierarchy.io import write_hier
    from h3dgs_tpu_torch.hierarchy.tree import build_hierarchy
    from h3dgs_tpu_torch.ops import kernels
    from h3dgs_tpu_torch.scene.camera import look_at_camera
    from h3dgs_tpu_torch.viewer.service import HierarchyRenderer, serve

    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    build_s = kernels.build()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in build_s.items())})")
    for name in kernels.SOURCES:
        with open(kernels.library_path(name) + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    h = build_hierarchy(*make_scene(rng))
    log(f"hierarchy build: {N_LEAVES} leaves -> {h.n_nodes} nodes in "
        f"{time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "merged.hier")
        t0 = time.perf_counter()
        write_hier(path, h)
        del h
        renderer = HierarchyRenderer(path, budget=BUDGET, device="cuda")
        torch.cuda.synchronize()
        log(f"write + open hierarchy: {time.perf_counter() - t0:.1f} s")

    cams = orbit_cams(look_at_camera)

    # --- the main path, counted ---
    kernels.reset_launches()
    frames, served = main_path(renderer, cams, look_at_camera, serve)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    log(f"main path: {frames} frames, kernel launches {launches}")
    for name, n in launches.items():
        assert n > 0, f"kernel {name} was not launched on the main path"
    assert launches["blend_fwd"] >= frames, (launches, frames)

    for cam, img, verify in served:
        want, _ = renderer.render(cam, SERVE_TAU)
        assert verify == "", verify
        got = np.frombuffer(img, np.uint8).reshape(want.shape)
        assert np.array_equal(got, want), "served frame != render()"
        assert want.max() > 0, "served frame is black"
    log(f"serve: {len(served)} replies equal renderer.render, "
        f"{HEIGHT}x{WIDTH}x3 B + verify string each")

    # --- stage breakdown (not counted) ---
    inputs = None
    for tau in TAUS:
        acc, counts, last = stage_times(renderer, cams, tau)
        if tau == TAUS[0]:
            inputs = last
        cut, entries, depth = (np.mean([c[i] for c in counts])
                               for i in range(3))
        log(f"stages tau={tau:4.1f} (ms, CUDA events, mean of {len(cams)} "
            f"fresh frames): " + ", ".join(f"{k} {v:.3f}"
                                            for k, v in acc.items())
            + f"; cut {cut:.0f}, entries {entries:.0f}, "
              f"max tile depth {depth:.0f}")

    # --- kernels against their plain versions (not counted) ---
    args, height, width = inputs
    rows = [check_blend(args, height, width, launches["blend_fwd"])]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"peak device memory allocated: {peak_gb:.2f} GB")

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
