#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port: the serving path, the
per-chunk training path and the hierarchy post-training path.

Drives ``h3dgs_tpu_torch`` end to end on one NVIDIA GPU at real sizes.
Serving: a seeded synthetic hierarchy of 1,000,000 leaves (the wavy
surface of ``scripts/bench_render.py``, SH degree 3), opened with
``HierarchyRenderer(budget=1 << 20)`` and rendered at 1920x1080 on a
16-camera orbit for tau in {0, 3, 6, 15}, fresh-cut and cached-cut frames,
then served over the network_gui wire protocol by ``serve()``. Training: a
synthetic chunk written with the port's own writers (1,000,000 points in
points3D.bin on the same surface, 24 views at 1600x900 rendered from the
ground truth, 16-bit inverse-depth PNGs, a 100,000-Gaussian scaffold with
10,000 skybox rows and chunk bounds), trained through
``h3dgs_tpu_torch.cli.train_single.main`` for 80 iterations (K1 + K2,
densification, opacity reset) and 20 more with the fused SSIM loss (K3).
Post-training: ``hierarchy_creator.main`` on the point cloud that run
saved (about 1.1M Gaussians, skybox rows excluded, the chunk's bounds and
scaffold), then ``train_post.main`` on that hierarchy and the same views
for 60 iterations (SH degree 3 stored and interpolated per node), 20 more
with the fused loss, and a run resumed from a checkpoint; the
``<hier>_opt`` it writes is opened by ``HierarchyRenderer``. Evaluation:
that ``<hier>_opt`` merged by ``hierarchy_merger.main`` from two chunks
splitting the training chunk at X = 0, the ``merged.hier`` served, and
evaluated by ``render_hierarchy.main`` on the 24 views at tau in {0, 3,
6, 15} (PSNR, SSIM, LPIPS with synthetic weights). Orchestration:
``python -m h3dgs_tpu_torch.cli.full_train`` on a two-chunk project at a
reduced size, then again with ``--skip_if_exists``.

Phases, each failing the run with its traceback:
  1. card name and power limit (nvidia-smi); fails without CUDA;
  2. build every kernel from ``h3dgs_tpu_torch/csrc`` (one nvcc each,
     started together);
  3. build and write the hierarchy, open the renderer;
  4. the serving path, with launch counts reset just before and read just
     after: renderer frames for every tau, then 3 socket requests through
     ``serve()`` whose replies are checked against ``renderer.render``;
  5. per-stage times with CUDA events (select, interpolate, project, bin,
     blend kernel, total) at each tau;
  6. write the training chunk;
  7. the training path, counted the same way: ``train_single.main`` for 80
     iterations; loss finite and falling, artifacts written and read back,
     locked skybox rows unchanged; step time and its per-stage split;
  8. the fused-loss training path, counted: 20 iterations with
     ``H3DGS_FUSED_SSIM=1``;
  9. hierarchy creation from the trained point cloud; the post-training
     paths, counted: 60 iterations, 20 with the fused loss, a resumed run;
     locked rows bit-equal, no cut truncated, ``<hier>_opt`` read back,
     validated and rendered; the post step's time, stages and busy share;
 10. the evaluation path, counted: merge (validated, leaves counted
     independently), one served frame of ``merged.hier``, the tau sweep
     (K1 once per frame, metrics finite, cuts coarsening with tau, per-
     frame render and metric times), LPIPS on the card against float64
     on the CPU;
 11. ``full_train`` in child processes on the card, and its resume;
 12. each kernel against its plain PyTorch version on one frame's or one
     view's inputs, with times and the kernel's bound; for the blend
     kernels also the wrapper's tile sort and the pack pre-pass on their
     own, and the times of the kernels they replaced; for the fused loss
     also its distance from the float64 plain version, on a natural view
     and on a dark image, at 1600x900 and 1920x1080.
The line before last is one JSON object with each kernel's numbers; the
last line is the contract's ``{"ok": true, "device": ...}``.

Run: python3 chip_smoke.py   (from the repository root, on a machine with
one CUDA card; a few minutes, most of it host-side scene building)
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

DEVICE = "cuda"
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
# Times of the blend kernels before their redesign, as PERF.md records them
# (section 6, the flat-training slice's final run: the same phases of this
# script on an NVIDIA H100 80GB HBM3 at 700.00 W).
K1_EARLIER_MS = 1.1617
K2_EARLIER_MS = 5.4961
# The fused loss as three launches, before its redesign (PERF.md section 6,
# the blend redesign's final run on the same card and limit).
K3_EARLIER_MS = 0.1834

# Training chunk.
TRAIN_POINTS = 1_000_000
TRAIN_VIEWS = 24
TRAIN_W, TRAIN_H = 1600, 900          # the reference's -1 resolution cap
SCAFFOLD_N = 100_000
SCAFFOLD_SKY = 10_000
CHUNK_EXTENT = 3.0
TRAIN_ITERS = 80
FUSED_ITERS = 20
# Post-training: iterations, of which the last POST_RESUMED run again from
# a checkpoint; then the fused-loss run.
POST_ITERS = 60
POST_RESUMED = 4
POST_FUSED_ITERS = 20
TRAIN_FLAGS = ["--densify_from_iter", "20", "--densification_interval",
               "30", "--opacity_reset_interval", "70", "--disable_viewer"]
# Evaluation: the post phase's <hier>_opt merged from two chunks that split
# the training chunk's box at X = 0, evaluated on the chunk's views at these
# taus. LPIPS runs with synthetic weights (the repository holds no
# pretrained ones); its card value of one (frame, ground truth) pair at
# 1600x900 is held against float64 on the CPU within LPIPS_REL. The limit
# sits between float32's distance from float64 and TF32's: with TF32 the
# error of the convolutions largely averages out of the mean over the
# image, so a limit of 1e-4 would let TF32 through (PERF.md, section 6).
# The check also computes the TF32 distance and fails if it is not beyond
# the limit.
EVAL_TAUS = (0.0, 3.0, 6.0, 15.0)
LPIPS_REL = 1e-6
# render.render against rasterize of the same rows: the same kernel on the
# same inputs, so only the exposure's float32 rounding (a few ulps of 1)
# separates them; a transposed exposure matrix would read ~1e-4.
RENDER_EXPOSURE_TOL = 2e-6
# full_train orchestration at a reduced size: two chunks of the same
# surface, ORCH_POINTS Gaussians in all (half in each chunk), ORCH_VIEWS
# views at ORCH_W x ORCH_H, ORCH_ITERS iterations per training stage.
ORCH_POINTS = 40_000
ORCH_VIEWS = 8
ORCH_W, ORCH_H = 800, 450
ORCH_ITERS = 30
ORCH_TIMEOUT_S = 600
# K2: about 20 FP32 operations to recompute alpha per evaluated (entry,
# pixel) pair up to the pixel's last contributing entry, and about 40 more
# per contributing pair (T by division, d_alpha, the chain to means2d and
# the conic, colors). Tolerance per output: atomicAdd order makes the
# per-Gaussian sums non-deterministic.
BWD_OPS_PER_PAIR = 20
BWD_OPS_PER_CONTRIB = 40
BWD_TOL_REL = 1e-3
BWD_MIN_COSINE = 0.9999
# H7, on the deepest tile alone, against float64: the kernel (T by
# division) may be no farther than the float32 plain version (a suffix by
# total minus prefix) in any of H7_REPS launches on the same inputs. Pixels
# whose float32 and float64 forward walks took different entries are left
# out of the cotangents: one skipped entry changes the final T by 1/255 of
# itself at least, rounding over the deepest walk by far less than
# H7_T_REL.
H7_T_REL = 1e-3
H7_REPS = 4
# K3: about 400 FP32 operations per channel pixel (8 blurred fields x 2
# passes x 11 taps x 2, plus the map and the coefficients).
SSIM_OPS_PER_VALUE = 400
# K3's limits come from two contracts, none from this kernel's readings.
# The reference's own kernel test (tests/test_pallas_ssim.py: uniform
# random images, the kernel against the float32 plain loss): loss within
# SSIM_LOSS_TOL, gradient within SSIM_REF_GRAD_TOL_REL of its largest
# value; held here at both sizes on such images. On a trained view and on
# dark images small denominators of the map amplify roundings (the float32
# plain version itself stands 2e-5 to 6e-5 of max |g| from float64 at its
# worst pixel), so there the gradient is held within SSIM_GRAD_TOL_REL of
# max |g| (the port's tolerance for this kernel since its first version)
# of both plain versions, the loss within SSIM_LOSS_TOL of the float64
# one, and the gradient's root-mean-square distance from float64 may not
# exceed the float32 plain version's.
SSIM_LOSS_TOL = 5e-7
SSIM_REF_GRAD_TOL_REL = 5e-6
SSIM_GRAD_TOL_REL = 1e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def make_scene(rng, n: int):
    """The bench_render wavy surface: leaf spacing ~0.006 world units, so
    interior nodes merge neighbouring splats and tau moves the cut."""
    from h3dgs_tpu_torch.utils.sh import rgb_to_sh
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
    from h3dgs_tpu_torch.ops.blend import (_launch_blend_fwd, blend_forward,
                                           blend_plain, pack_rows,
                                           pack_rows_plain, tile_order)

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

    # The wrapper as the main path calls it (tile sort, pack pre-pass,
    # blend), then its parts on their own.
    ms = time_ms(lambda: blend_forward(*args, height, width), 20)
    order = tile_order(args[7])
    order_ms = time_ms(lambda: tile_order(args[7]), 20)
    launch_ms = time_ms(lambda: _launch_blend_fwd(*args, order, height,
                                                  width), 20)
    rows = pack_rows(*args[:5])
    assert torch.equal(rows, pack_rows_plain(*args[:5])), "pack pre-pass"
    pack_ms = time_ms(lambda: pack_rows(*args[:5]), 20)
    pack_plain_ms = time_ms(lambda: pack_rows_plain(*args[:5]), 5)
    log(f"blend_fwd wrapper {ms:.4f} ms = tile sort {order_ms:.4f} + launch "
        f"{launch_ms:.4f} (of which the pack pre-pass of {rows.shape[0]} "
        f"rows {pack_ms:.4f}; equal to torch.cat, which takes "
        f"{pack_plain_ms:.4f}); before the redesign {K1_EARLIER_MS} ms")
    del rows
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
            "library_ms": None, "earlier_ms": K1_EARLIER_MS,
            "launch_ms": launch_ms, "tile_sort_ms": order_ms,
            "pack_ms": pack_ms}


def train_cameras(look_at_camera):
    """TRAIN_VIEWS views of the surface on a ring, radius 5, 1600x900."""
    return [look_at_camera(eye=(5 * np.sin(a), -1.5, -5 * np.cos(a)),
                           target=(0.0, 0.0, 0.0), fovx=1.2,
                           width=TRAIN_W, height=TRAIN_H)
            for a in np.linspace(0, 2 * np.pi, TRAIN_VIEWS, endpoint=False)]


def write_views(root: str, cameras, gt, depths: bool):
    """Render the Gaussians ``gt`` from each camera on the card; write the
    views as PNGs under ``root/images`` (and, with ``depths``, 16-bit
    inverse depths under ``root/depths``, depth_params scale 1). Returns
    the COLMAP camera and image records and the depth params."""
    from h3dgs_tpu_torch.io import colmap as colmap_io
    from h3dgs_tpu_torch.io.image import write_png
    from h3dgs_tpu_torch.ops.rasterize import rasterize

    bg = torch.zeros(3, device=DEVICE)
    cams, imgs, depth_params = {}, {}, {}
    for i, cam in enumerate(cameras):
        with torch.no_grad():
            out = rasterize(*gt, cam, 3, bg)
        img = (out["render"].clamp(0, 1) * 255 + 0.5).to(torch.uint8)
        name = f"view_{i:03d}.png"
        write_png(os.path.join(root, "images", name),
                  img.permute(1, 2, 0).cpu().numpy(), level=1)
        if depths:
            raw = (out["invdepth"][0] * 65536.0).clamp(0, 65535).to(
                torch.int32)
            write_png(os.path.join(root, "depths", name),
                      raw.cpu().numpy().astype(np.uint16), level=1)
            depth_params[name[:-4]] = {"scale": 1.0, "offset": 0.0}
        fx = cam.width / (2.0 * float(cam.tanfovx))
        fy = cam.height / (2.0 * float(cam.tanfovy))
        cams[i + 1] = colmap_io.ColmapCamera(
            i + 1, "PINHOLE", cam.width, cam.height,
            np.asarray([fx, fy, cam.width / 2.0, cam.height / 2.0]))
        view = cam.view.numpy()
        imgs[i + 1] = colmap_io.ColmapImage(
            i + 1, colmap_io.rotmat2qvec(view[:3, :3]),
            view[:3, 3].astype(np.float64), i + 1, name, np.zeros((0, 2)),
            np.zeros(0, np.int64))
    return cams, imgs, depth_params


def colmap_points(xyz, shs, rng):
    """points3D records: the Gaussians' positions jittered by 0.01 and
    their base colours, no tracks."""
    from h3dgs_tpu_torch.io import colmap as colmap_io
    from h3dgs_tpu_torch.utils.sh import SH_C0

    n = xyz.shape[0]
    colors = np.clip(shs[:, 0] * SH_C0 + 0.5, 0, 1)
    return colmap_io.ColmapPoints3D(
        ids=np.arange(1, n + 1, dtype=np.int64),
        xyz=(xyz + rng.normal(0, 0.01, xyz.shape)).astype(np.float64),
        rgb=(colors * 255 + 0.5).astype(np.uint8), error=np.zeros(n),
        track_offsets=np.zeros(n + 1, np.int64),
        track_image_ids=np.zeros(0, np.int32),
        track_point2d_idxs=np.zeros(0, np.int32))


def write_chunk(root: str, rng):
    """A synthetic chunk in the reference's layout, written with the port's
    own writers: COLMAP model (points3D.bin with TRAIN_POINTS jittered
    ground-truth positions and colors), PNG views rendered from the
    ground truth (surface and sky) with the port's rasterizer, 16-bit
    inverse-depth PNGs with depth_params.json, a degree-1 scaffold
    (point_cloud.ply + pc_info.txt) and the chunk bounds (center.txt /
    extent.txt)."""
    from h3dgs_tpu_torch.io import colmap as colmap_io
    from h3dgs_tpu_torch.io import meta as meta_io
    from h3dgs_tpu_torch.io.ply import write_gaussian_ply
    from h3dgs_tpu_torch.scene.camera import look_at_camera
    from h3dgs_tpu_torch.utils.sh import SH_C0

    xyz, shs, alpha, scaling, rotation = make_scene(rng, TRAIN_POINTS)
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "depths"))

    # Scaffold (SH degree 1): skybox rows first, on a far sphere, locked in
    # training and part of every photograph; then Gaussians in the ring
    # load_scaffold selects (0.5 to 1.5 extents from the chunk center,
    # Chebyshev on x and y), placed below the cameras and out of every
    # view, as neighbouring chunks' Gaussians would be.
    sky = SCAFFOLD_SKY
    ring = SCAFFOLD_N - sky
    theta = rng.uniform(0, 2 * np.pi, sky)
    phi = np.arccos(1.0 - 1.4 * rng.random(sky))
    sky_xyz = 40.0 * np.stack([np.cos(theta) * np.sin(phi), -np.cos(phi),
                               np.sin(theta) * np.sin(phi)], axis=1)
    ring_xyz = np.stack([rng.uniform(-0.45, 0.45, ring) * CHUNK_EXTENT,
                         -rng.uniform(0.85, 1.45, ring) * CHUNK_EXTENT,
                         rng.uniform(-0.45, 0.45, ring) * CHUNK_EXTENT],
                        axis=1)
    sc_xyz = np.concatenate([sky_xyz, ring_xyz]).astype(np.float32)
    sc_rgb = np.concatenate([np.tile([0.7, 0.8, 0.95], (sky, 1)),
                             rng.uniform(0.1, 0.9, (ring, 3))])
    sc_sh = np.zeros((SCAFFOLD_N, 4, 3), np.float32)
    sc_sh[:, 0] = (sc_rgb - 0.5) / SH_C0
    sc_sh[:, 1:] = rng.normal(0.0, 0.02, (SCAFFOLD_N, 3, 3))
    sc_opacity = np.full((SCAFFOLD_N, 1), 1.0, np.float32)   # logit
    sc_scale = np.concatenate([np.full((sky, 3), np.log(1.5)),
                               np.full((ring, 3), np.log(0.02))])
    sc_rot = np.tile([1.0, 0.0, 0.0, 0.0], (SCAFFOLD_N, 1))

    # Ground truth photographed: the surface and the sky.
    sky_sh = np.zeros((sky, 16, 3), np.float32)
    sky_sh[:, :4] = sc_sh[:sky]
    gt = [torch.as_tensor(np.concatenate(a).astype(np.float32),
                          device=DEVICE) for a in (
        (xyz, sky_xyz), (np.exp(scaling), np.exp(sc_scale[:sky])),
        (rotation, sc_rot[:sky]),
        (alpha, np.full(sky, 1.0 / (1.0 + np.exp(-1.0)))), (shs, sky_sh))]
    cams, imgs, depth_params = write_views(
        root, train_cameras(look_at_camera), gt, depths=True)
    del gt
    pts = colmap_points(xyz, shs, rng)
    colmap_io.write_model_binary(sparse, cams, imgs, pts)
    with open(os.path.join(sparse, "depth_params.json"), "w") as f:
        json.dump(depth_params, f)

    sc_dir = os.path.join(root, "scaffold")
    write_gaussian_ply(os.path.join(sc_dir, "point_cloud.ply"), sc_xyz,
                       sc_sh[:, :1], sc_sh[:, 1:], sc_opacity, sc_scale,
                       sc_rot)
    meta_io.write_pc_info(os.path.join(sc_dir, "pc_info.txt"), sky)
    meta_io.write_vec(os.path.join(root, "center.txt"), [0.0, 0.0, 0.0])
    meta_io.write_vec(os.path.join(root, "extent.txt"), [CHUNK_EXTENT] * 3)
    return sc_dir


def _run_observed(main, loop_attr: str, observed_of, argv, fused: bool):
    """``main(argv)`` with ``train.loop.<loop_attr>`` wrapped by
    ``observed_of(original, rec)`` and ``H3DGS_FUSED_SSIM`` set for the
    run. The wrapper fills ``rec`` (per-step losses under "photo" /
    "depth", one CUDA event per step under "events"); the step times
    between those events come back under "step_ms"."""
    from h3dgs_tpu_torch.train import loop

    rec = {"photo": [], "depth": [], "events": []}
    orig = getattr(loop, loop_attr)
    old_env = os.environ.get("H3DGS_FUSED_SSIM")
    os.environ["H3DGS_FUSED_SSIM"] = "1" if fused else "0"
    setattr(loop, loop_attr, observed_of(orig, rec))
    try:
        main(argv)
        torch.cuda.synchronize()
    finally:
        setattr(loop, loop_attr, orig)
        if old_env is None:
            os.environ.pop("H3DGS_FUSED_SSIM")
        else:
            os.environ["H3DGS_FUSED_SSIM"] = old_env
    rec["photo"] = [float(x) for x in rec["photo"]]
    rec["depth"] = [float(x) for x in rec["depth"]]
    evs = rec.pop("events")
    rec["step_ms"] = [a[1].elapsed_time(b[1]) for a, b in zip(evs, evs[1:])]
    return rec


def _step_recorder(rec):
    def cb(it, out):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        rec["events"].append((it, ev))
        rec["photo"].append(out.photo_loss)
        rec["last"] = out
        return out
    return cb


def run_train_cli(argv, fused: bool = False):
    """``train_single.main(argv)``, observed through ``train_flat``'s step
    callback: per-step losses, a CUDA event after every step, the locked
    rows before and after, the final state."""
    from h3dgs_tpu_torch.cli import train_single

    def observed_of(orig, rec):
        def observed(cfg, scene, **kw):
            st = scene.state
            locked = st.locked_rows_mask()
            rec["locked0"] = {k: v[locked].clone()
                              for k, v in st.trainable_dict().items()}
            rec["n_locked"] = int(locked.sum())
            record = _step_recorder(rec)

            def cb(it, out):
                rec["depth"].append(record(it, out).depth_loss)

            state, exposure = orig(cfg, scene, step_cb=cb, **kw)
            rec["state"], rec["scene"] = state, scene
            rec["locked1"] = {k: v[state.locked_rows_mask()].clone()
                              for k, v in state.trainable_dict().items()}
            return state, exposure
        return observed

    return _run_observed(train_single.main, "train_flat", observed_of, argv,
                         fused)


def run_post_cli(argv, fused: bool = False):
    """``train_post.main(argv)``, observed through ``train_post``'s step
    callback: per-step losses and cut sizes, a CUDA event after every
    step, the whole state before and the locked rows' mask, the final
    state. Under "cuts", per step: the cut size the step reported, the
    rows it handed to the rasterizer less the skybox, and the cut mask's
    count computed here afterwards from the step's camera and limit (the
    three are equal unless a cut was truncated)."""
    from h3dgs_tpu_torch.cli import train_post
    from h3dgs_tpu_torch.hierarchy.cut import cut_mask
    from h3dgs_tpu_torch.train import post_step

    def observed_of(orig, rec):
        def observed(cfg, scene, **kw):
            st = scene.state
            locked = (torch.as_tensor(scene.anchor_mask, device=st.device)
                      | st.locked_rows_mask())
            rec["locked"] = locked
            rec["n_anchor"] = int(scene.anchor_mask.sum())
            rec["state0"] = {k: v.clone()
                             for k, v in st.trainable_dict().items()}
            reported, selected, splatted = [], [], []
            record = _step_recorder(rec)

            def cb(it, out):
                record(it, out)
                reported.append(out.cut_size)

            select0 = post_step.select_cut_gaussians
            splat0 = post_step.splat_cut_gaussians

            def select(state, nodes, boxes, cam_center, limit, *a, **k):
                selected.append((cam_center, limit))
                return select0(state, nodes, boxes, cam_center, limit, *a,
                               **k)

            def splat(xyz, *a, **k):
                splatted.append(int(xyz.shape[0]))
                return splat0(xyz, *a, **k)

            post_step.select_cut_gaussians = select
            post_step.splat_cut_gaussians = splat
            try:
                state = orig(cfg, scene, step_cb=cb, **kw)
            finally:
                post_step.select_cut_gaussians = select0
                post_step.splat_cut_gaussians = splat0
            nodes = torch.as_tensor(scene.hierarchy.nodes, device=st.device)
            boxes = torch.as_tensor(scene.hierarchy.boxes, device=st.device)
            assert len(reported) == len(selected) == len(splatted)
            rec["cuts"] = [
                (int(c), rows - st.n_skybox,
                 int(cut_mask(nodes, boxes, limit, center)[0].sum()))
                for c, rows, (center, limit)
                in zip(reported, splatted, selected)]
            rec["state"], rec["scene"] = state, scene
            return state
        return observed

    return _run_observed(train_post.main, "train_post", observed_of, argv,
                         fused)


def train_stage_times(state, batch, sh_degree: int, opt_cfg, reps: int = 5):
    """Per-stage CUDA-event times of one train step on one view, following
    train/step.py's order: project (with autograd), bin, K1, loss (with
    exposure, depth and the photometric loss), backward (K2 + projection
    backward), update (stats, sparse Adam, shrink). Mean of ``reps``.
    Returns (stage ms dict, K2's inputs)."""
    from h3dgs_tpu_torch.model import densify as densify_lib
    from h3dgs_tpu_torch.ops import adam as adam_lib
    from h3dgs_tpu_torch.ops.binning import bin_gaussians
    from h3dgs_tpu_torch.ops.blend import blend_forward
    from h3dgs_tpu_torch.ops.projection import (ProjectedGaussians,
                                                project_gaussians)
    from h3dgs_tpu_torch.ops.rasterize import blend_args
    from h3dgs_tpu_torch.train.step import apply_exposure, decode_view
    from h3dgs_tpu_torch.utils import losses, schedules

    names = ("project", "bin", "blend_fwd K1", "loss",
             "backward (K2 + projection)", "adam + stats + shrink")
    acc = dict.fromkeys(names + ("total",), 0.0)
    b = decode_view(batch)
    cam = b.camera
    opt = adam_lib.init(state.trainable_dict())
    exposure = torch.eye(3, 4, device=state.device)
    k2_inputs = None
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state.trainable_dict().items()}
        offset = torch.zeros((state.capacity, 2), device=state.device,
                             requires_grad=True)
        st = state.replace_trainable(params)
        proj = project_gaussians(st.xyz, st.get_scaling(),
                                 st.get_rotation(), st.get_opacity()[:, 0],
                                 st.get_features(sh_degree), cam, sh_degree)
        proj = proj._replace(means2d=proj.means2d + offset)
        ev[1].record()
        binned = bin_gaussians(ProjectedGaussians(
            *(t.detach() for t in proj)), cam.height, cam.width)
        ev[2].record()
        args = blend_args(proj, binned)
        color, invd, final_t, last = blend_forward(*args, cam.height,
                                                   cam.width)
        ev[3].record()
        image = torch.clamp(apply_exposure(color, exposure), 0.0, 1.0)
        image = image * b.alpha_mask
        photo = losses.photometric_loss(image, b.gt_image,
                                        opt_cfg.lambda_dssim)
        depth = torch.mean(torch.abs(invd - b.invdepth) * b.depth_mask)
        loss = photo + depth
        ev[4].record()
        inputs = list(params.values()) + [offset, color, invd, final_t]
        grads = torch.autograd.grad(loss, inputs, allow_unused=True,
                                    materialize_grads=True)
        ev[5].record()
        with torch.no_grad():
            g = dict(zip(params, grads[:len(params)]))
            new = densify_lib.add_densification_stats(
                state, grads[len(params)], proj.radius, proj.radius > 0)
            relevant = (g["opacity"][:, 0] != 0) & state.alive
            lrs = schedules.gaussian_lr_dict(opt_cfg, 50)
            newp, _ = adam_lib.sparse_adam_update(state.trainable_dict(), g,
                                                  opt, lrs, relevant)
            new = densify_lib.shrink_big_gaussians(
                new.replace_trainable(newp), 5.0, 0.02)
        ev[6].record()
        torch.cuda.synchronize()
        for i, name in enumerate(names):
            acc[name] += ev[i].elapsed_time(ev[i + 1]) / reps
        acc["total"] += ev[0].elapsed_time(ev[6]) / reps
        # The blend's own cotangents (d loss / d color, invd, final T).
        cot = grads[len(params) + 1:]
        k2_inputs = (tuple(a.detach() for a in args), color.detach(),
                     invd.detach(), final_t.detach(), last,
                     tuple(c.contiguous() for c in cot), cam.height,
                     cam.width, image.detach(), b.gt_image)
        del new, grads, proj
    return acc, k2_inputs


def flat_step_runner(state, batch):
    """A closure that takes one flat train step on ``batch`` from
    ``state`` (the state is not advanced: every call does the same
    work)."""
    from h3dgs_tpu_torch.config import OptimizationConfig
    from h3dgs_tpu_torch.ops import adam as adam_lib
    from h3dgs_tpu_torch.ops.rasterize import RasterizeConfig
    from h3dgs_tpu_torch.train.step import make_train_step

    step = make_train_step(OptimizationConfig(), RasterizeConfig())
    opt = adam_lib.init(state.trainable_dict())
    exposure = torch.eye(3, 4, device=state.device).repeat(
        int(batch.image_idx) + 1, 1, 1)
    exp_opt = adam_lib.init({"exposure": exposure})
    bg = torch.zeros(3, device=state.device)
    return lambda: step(state, opt, exposure, exp_opt, batch, 50, bg, 5.0,
                        5.0, 0)


def profile_steps(run, what: str, n_steps: int = 5):
    """Device time of ``n_steps`` calls of ``run`` (one step each) under
    ``torch.profiler``: the busy share of the wall time and the kernels
    that take the most device time. Prints "not measured" when the
    profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side rows only (kernels and copies): the operator rows repeat
    # their kernels' time.
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    if device_ms <= 0:
        log(f"profile of the {what}: no device activity recorded "
            f"(device busy share not measured)")
        return
    log(f"profile of {n_steps} {what}s on one view: wall "
        f"{wall_ms / n_steps:.3f} ms per step, device kernels "
        f"{device_ms / n_steps:.3f} ms per step, device busy "
        f"{100 * device_ms / wall_ms:.1f} % of the wall time")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:10]:
        log(f"  {e.self_device_time_total / 1e3 / n_steps:8.3f} ms/step "
            f"{e.count // n_steps:5d} calls/step  {e.key[:90]}")


def post_stage_times(state, batch, nodes, boxes, anchor_mask, exp_row,
                     limit: float, sh_degree: int, opt_cfg, reps: int = 5):
    """Per-stage CUDA-event times of one post step on one view, following
    train/post_step.py's order: select the cut, interpolate (the [M, 64]
    table over every node, the gathers and lerp, the skybox rows),
    project, bin, K1, loss (exposure, clamp, alpha mask, photometric),
    backward (K2 + projection + interpolation table by autograd), update
    (gradient locks + dense Adam). Mean of ``reps``."""
    from h3dgs_tpu_torch.hierarchy import cut as cut_lib
    from h3dgs_tpu_torch.ops import adam as adam_lib
    from h3dgs_tpu_torch.ops.binning import bin_gaussians
    from h3dgs_tpu_torch.ops.blend import blend_forward
    from h3dgs_tpu_torch.ops.projection import (ProjectedGaussians,
                                                project_gaussians)
    from h3dgs_tpu_torch.ops.rasterize import blend_args
    from h3dgs_tpu_torch.train.step import apply_exposure, decode_view
    from h3dgs_tpu_torch.utils import losses, schedules

    names = ("select", "interpolate (table + gather + sky)", "project",
             "bin", "blend_fwd K1", "loss", "backward (K2 + autograd)",
             "locks + dense adam")
    acc = dict.fromkeys(names + ("total",), 0.0)
    b = decode_view(batch)
    cam = b.camera
    opt = adam_lib.init(state.trainable_dict())
    n_sky, cap = state.n_skybox, state.capacity
    k = (sh_degree + 1) ** 2
    cut_size = 0
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(9)]
        ev[0].record()
        cut = cut_lib.expand_to_size(nodes, boxes, limit, cam.cam_center,
                                     None)
        cut_size = int(cut.count)
        ev[1].record()
        params = {kk: v.detach().requires_grad_(True)
                  for kk, v in state.trainable_dict().items()}
        xyz, scales, quats, opac, shs = cut_lib.interpolate_cut(params, cut)
        sky = slice(cap - n_sky, cap)
        xyz = torch.cat([xyz, params["xyz"][sky]])
        scales = torch.cat([scales, torch.exp(params["scaling"][sky])])
        quats = torch.cat([quats, params["rotation"][sky]])
        opac = torch.cat([opac, torch.abs(params["opacity"][sky, 0])])
        shs = torch.cat([shs, torch.cat([params["f_dc"][sky],
                                         params["f_rest"][sky]], dim=1)])
        ev[2].record()
        proj = project_gaussians(xyz, scales, quats, opac, shs[:, :k], cam,
                                 sh_degree)
        ev[3].record()
        binned = bin_gaussians(ProjectedGaussians(
            *(t.detach() for t in proj)), cam.height, cam.width)
        ev[4].record()
        color, _, final_t, _ = blend_forward(*blend_args(proj, binned),
                                             cam.height, cam.width)
        ev[5].record()
        image = torch.clamp(apply_exposure(color, exp_row), 0.0, 1.0)
        photo = losses.photometric_loss(image * b.alpha_mask, b.gt_image,
                                        opt_cfg.lambda_dssim)
        ev[6].record()
        grads = torch.autograd.grad(photo, list(params.values()),
                                    allow_unused=True,
                                    materialize_grads=True)
        ev[7].record()
        with torch.no_grad():
            locked = anchor_mask | state.locked_rows_mask()
            g = {}
            for kk, gv in zip(params, grads):
                m = locked.reshape((-1,) + (1,) * (gv.dim() - 1))
                g[kk] = torch.where(m, torch.zeros_like(gv), gv)
            lrs = schedules.gaussian_lr_dict(opt_cfg, 50)
            all_rows = torch.ones(cap, dtype=torch.bool,
                                  device=state.device)
            adam_lib.sparse_adam_update(state.trainable_dict(), g, opt, lrs,
                                        all_rows)
        ev[8].record()
        torch.cuda.synchronize()
        for i, name in enumerate(names):
            acc[name] += ev[i].elapsed_time(ev[i + 1]) / reps
        acc["total"] += ev[0].elapsed_time(ev[8]) / reps
        del grads, proj, g
    return acc, cut_size


def _close_grads(got, want):
    """(max |d| / max |want|, cosine) of two gradient tensors."""
    g = got.double().reshape(-1)
    w = want.double().reshape(-1)
    scale = float(w.abs().max())
    rel = float((g - w).abs().max()) / max(scale, 1e-30)
    cos = float(torch.dot(g, w) / (g.norm() * w.norm()).clamp_min(1e-30))
    return rel, cos, scale


H7_OUTPUTS = ("means2d", "conic", "rgb", "opacity", "inv_depth")


def h7_forward_agreement(args, fwd, h, w):
    """Where the float32 forward ``fwd`` (K1's color, inverse depth, final
    T, last entry) and the plain forward in float64 walked the same
    entries. A pixel's walk is a chain of discrete tests (alpha >= 1/255,
    T >= 1e-4 after the entry); where an alpha or a T lies within rounding
    of its threshold the two float types decide differently, and from
    there on they differentiate different functions: the last entry
    differs, or the final T by at least the skipped entry's 1/255. Returns
    (agree [H, W] bool, the float64 forward)."""
    from h3dgs_tpu_torch.ops.blend import blend_plain

    a64 = tuple(a.double() if a.is_floating_point() else a for a in args)
    fwd64 = blend_plain(*a64, h, w)
    t32, t64 = fwd[2].double(), fwd64[2]
    agree = (fwd[3] == fwd64[3]) & ((t32 - t64).abs() <= H7_T_REL * t64)
    return agree, fwd64


def h7_distances(args, fwd, fwd64, cot, keep, h, w, reps: int = 1):
    """K2 (``reps`` launches on the same inputs) and the float32 plain
    backward, each against the float64 plain backward, with the
    cotangents ``cot`` zeroed outside ``keep``. Returns max |d| / max |g|
    per output (H7_OUTPUTS): {"kernel": [per launch], "plain": [...]}."""
    from h3dgs_tpu_torch.ops.blend import (blend_backward,
                                           blend_backward_plain)

    masked = [torch.where(keep, c, torch.zeros_like(c)).contiguous()
              for c in cot]
    a64 = tuple(a.double() if a.is_floating_point() else a for a in args)
    g64 = blend_backward_plain(*a64, *fwd64[:3],
                               *(m.double() for m in masked), h, w)
    gp = blend_backward_plain(*args, *fwd[:3], *masked, h, w)
    out = {"plain": [_close_grads(b, r)[0] for b, r in zip(gp, g64)],
           "kernel": []}
    for _ in range(reps):
        gk = blend_backward(*args, *fwd, *masked, h, w)
        out["kernel"].append([_close_grads(a, r)[0]
                              for a, r in zip(gk, g64)])
    return out


def check_blend_bwd(k2_inputs, launches):
    """K2 against blend_backward_plain on one training view's inputs and
    the loss's own cotangents; and on the deepest tile alone (T by
    division over the longest walk, hazard H7)."""
    from h3dgs_tpu_torch.ops.blend import (_blend_backward_cuda,
                                           _launch_blend_fwd, blend_backward,
                                           blend_backward_plain, tile_order)

    args, color, invd, final_t, last, cot, h, w = k2_inputs[:8]
    g_color, g_invd, g_t = cot

    def kern():
        return blend_backward(*args, color, invd, final_t, last, g_color,
                              g_invd, g_t, h, w)

    def plain():
        return blend_backward_plain(*args, color, invd, final_t, g_color,
                                    g_invd, g_t, h, w)

    # As autograd calls it on the main path: on the rows K1's launch
    # packed and the tile order K1 used, both saved by the forward.
    order = tile_order(args[7])
    _, rows = _launch_blend_fwd(*args, order, h, w)

    def kern_saved():
        return _blend_backward_cuda(None, rows, args[5], args[6], order,
                                    final_t, last, g_color, g_invd, g_t, h,
                                    w)

    got = kern()
    got_saved = kern_saved()
    torch.cuda.synchronize()
    *want, pairs, contrib = blend_backward_plain(
        *args, color, invd, final_t, g_color, g_invd, g_t, h, w, last=last)
    torch.cuda.synchronize()
    worst = 0.0
    for name, a, a_saved, b in zip(("means2d", "conic", "rgb", "opacity",
                                    "inv_depth"), got, got_saved, want):
        rel, cos, scale = _close_grads(a, b)
        rel_s, cos_s, _ = _close_grads(a_saved, b)
        log(f"blend_bwd vs plain, {name}: max |d| / max |g| {rel:.3e}, "
            f"cosine {cos:.9f} (max |g| {scale:.3e}); on the forward's "
            f"saved rows {rel_s:.3e}, {cos_s:.9f}")
        assert rel <= BWD_TOL_REL and cos >= BWD_MIN_COSINE, (name, rel, cos)
        assert rel_s <= BWD_TOL_REL and cos_s >= BWD_MIN_COSINE, (
            name, rel_s, cos_s)
        worst = max(worst, float((a - b).abs().max()),
                    float((a_saved - b).abs().max()))
    del got_saved
    nz_k, nz_p = got[3] != 0, want[3] != 0
    tiny = (got[3].abs() < 1e-12) & (want[3].abs() < 1e-12)
    mask_eq = bool(((nz_k == nz_p) | tiny).all())
    log(f"blend_bwd: sparse-Adam mask rows (g_opacity != 0) kernel "
        f"{int(nz_k.sum())}, plain {int(nz_p.sum())}; equal up to "
        f"|g| < 1e-12: {mask_eq}")
    assert mask_eq

    # H7: the deepest tile alone, the kernel and the float32 plain version
    # each against the plain version in float64.
    tile_count = args[7]
    deep = int(torch.argmax(tile_count))
    tiles_x = -(-w // 16)
    ty, tx = divmod(deep, tiles_x)
    keep = torch.zeros((h, w), dtype=torch.bool, device=g_t.device)
    keep[ty * 16:(ty + 1) * 16, tx * 16:(tx + 1) * 16] = True
    fwd = (color, invd, final_t, last)
    agree, fwd64 = h7_forward_agreement(args, fwd, h, w)
    n_left_out = int((keep & ~agree).sum())
    d = h7_distances(args, fwd, fwd64, cot, keep & agree, h, w,
                     reps=H7_REPS)
    for name, dk, dp in zip(H7_OUTPUTS, d["kernel"][0], d["plain"]):
        log(f"blend_bwd H7, deepest tile ({int(tile_count[deep])} entries, "
            f"{n_left_out} pixels of differing float32 and float64 walks "
            f"left out), {name}: max |d| / max |g| against float64: kernel "
            f"{dk:.3e}, float32 plain {dp:.3e}")
    per_launch = [max(r) for r in d["kernel"]]
    worst_k, worst_p = max(per_launch), max(d["plain"])
    log(f"blend_bwd H7: worst output over {H7_REPS} launches on the same "
        f"inputs, kernel {min(per_launch):.3e} to {worst_k:.3e}, float32 "
        f"plain {worst_p:.3e}")
    # T by division must not drift: in no launch is the kernel's worst
    # output farther from float64 than the float32 plain version's.
    assert worst_k <= worst_p, (worst_k, worst_p)

    ms = time_ms(kern_saved, 20)
    wrapper_ms = time_ms(kern, 20)
    log(f"blend_bwd on the forward's saved rows and tile order (the main "
        f"path) {ms:.4f} ms; the standalone wrapper (tile sort and pack "
        f"pre-pass of its own) {wrapper_ms:.4f} ms; before the redesign "
        f"{K2_EARLIER_MS} ms")
    plain_ms = time_ms(plain, 1)
    gauss_idx, tile_start = args[5], args[6]
    n_ref = int(torch.unique(gauss_idx).numel())
    n_bytes = (80 * n_ref + 4 * gauss_idx.numel() + 4 * tile_start.numel()
               + 28 * h * w)
    t_ops = ((BWD_OPS_PER_PAIR * pairs + BWD_OPS_PER_CONTRIB * contrib)
             / PEAK_FP32_FLOPS * 1e3)
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    log(f"blend_bwd at {w}x{h}: {gauss_idx.numel()} entries, {n_ref} "
        f"Gaussians referenced, {pairs} evaluated pairs, {contrib} "
        f"contributing; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms; bound "
        f"{max(t_ops, t_bytes):.4f} ms (operations {t_ops:.4f}, bytes "
        f"{t_bytes:.4f})")
    return {"name": "blend_bwd", "route": "cuda",
            "source": "h3dgs_tpu_torch/csrc/blend_bwd.cu",
            "replaces": "h3dgs_tpu/ops/pallas_blend.py:555",
            "launches": launches, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "earlier_ms": K2_EARLIER_MS,
            "wrapper_ms": wrapper_ms}


def _ssim_against_float64(pred, target, what: str):
    """The kernel and the float32 plain version, each against the float64
    plain version on the same inputs (limits: see SSIM_LOSS_TOL). Returns
    the kernel's (loss, grad), the float32 plain version's, and the
    latter's loss distance from float64."""
    from h3dgs_tpu_torch.ops.ssim import (fused_photometric_forward,
                                          fused_photometric_plain)

    loss, grad = fused_photometric_forward(pred, target, 0.2)
    torch.cuda.synchronize()
    want_loss, want_grad = fused_photometric_plain(pred, target, 0.2)
    ref_loss, ref_grad = fused_photometric_plain(pred.double(),
                                                 target.double(), 0.2)
    k_loss = abs(float(loss) - float(ref_loss))
    p_loss = abs(float(want_loss) - float(ref_loss))
    k_grad = _close_grads(grad, ref_grad)[0]
    p_grad = _close_grads(want_grad, ref_grad)[0]
    scale = float(ref_grad.abs().max())
    k_rms = float((grad.double() - ref_grad).pow(2).mean().sqrt()) / scale
    p_rms = float((want_grad.double() - ref_grad).pow(2).mean().sqrt()) \
        / scale
    log(f"ssim against float64, {what} {pred.shape[2]}x{pred.shape[1]}: "
        f"loss |d| kernel {k_loss:.3e}, float32 plain {p_loss:.3e}; grad "
        f"rms |d| / max |g| kernel {k_rms:.3e}, float32 plain {p_rms:.3e};"
        f" max |d| / max |g| kernel {k_grad:.3e}, float32 plain "
        f"{p_grad:.3e}")
    assert torch.isfinite(grad).all() and math.isfinite(float(loss)), what
    assert k_loss <= SSIM_LOSS_TOL, (what, k_loss)
    assert k_grad <= SSIM_GRAD_TOL_REL, (what, k_grad)
    assert k_rms <= p_rms, (what, k_rms, p_rms)
    return (loss, grad), (want_loss, want_grad), p_loss


def _ssim_reference_contract(h: int, w: int):
    """The reference's kernel test at the card's sizes: uniform random
    images from a numpy seed, the kernel against the float32 plain
    version."""
    from h3dgs_tpu_torch.ops.ssim import (fused_photometric_forward,
                                          fused_photometric_plain)

    rng = np.random.default_rng(h * 1000 + w)
    x, y = (torch.as_tensor(rng.uniform(0, 1, (3, h, w)).astype(np.float32),
                            device=DEVICE) for _ in range(2))
    loss, grad = fused_photometric_forward(x, y, 0.2)
    want_loss, want_grad = fused_photometric_plain(x, y, 0.2)
    d_loss = abs(float(loss) - float(want_loss))
    d_grad = _close_grads(grad, want_grad)[0]
    log(f"ssim vs plain on uniform random images {w}x{h} (the reference's "
        f"kernel test): loss |d| {d_loss:.3e} (tolerance {SSIM_LOSS_TOL:g}),"
        f" grad max |d| / max |g| {d_grad:.3e} (tolerance "
        f"{SSIM_REF_GRAD_TOL_REL:g})")
    assert d_loss <= SSIM_LOSS_TOL, (h, w, d_loss)
    assert d_grad <= SSIM_REF_GRAD_TOL_REL, (h, w, d_grad)


def check_ssim(pred, target, launches):
    """K3 against fused_photometric_plain on one training view's render
    and its ground truth (1600x900), and against the float64 plain
    version there, on the same pair resampled to 1920x1080, and on dark
    low-variance images of both sizes (the SSIM variance terms cancel);
    and on uniform random images as the reference's kernel test does."""
    from h3dgs_tpu_torch.ops.ssim import (fused_photometric_forward,
                                          fused_photometric_plain)

    pred = pred.contiguous()
    target = target.contiguous()
    (loss, grad), (want_loss, want_grad), plain_err = \
        _ssim_against_float64(pred, target, "natural view")
    d_loss = abs(float(loss) - float(want_loss))
    scale = float(want_grad.abs().max())
    d_grad = float((grad - want_grad).abs().max())
    log(f"ssim vs plain at {pred.shape[2]}x{pred.shape[1]}: loss "
        f"{float(loss):.7f} vs {float(want_loss):.7f} (|d| {d_loss:.3e}; "
        f"the kernel is within {SSIM_LOSS_TOL:g} of float64, the plain "
        f"version {plain_err:.3e} from it, so at most their sum); grad max |d| {d_grad:.3e} = "
        f"{d_grad / max(scale, 1e-30):.3e} of max |g| (tolerance "
        f"{SSIM_GRAD_TOL_REL:g})")
    assert d_loss <= SSIM_LOSS_TOL + plain_err, (d_loss, plain_err)
    assert d_grad <= SSIM_GRAD_TOL_REL * scale, (d_grad, scale)
    again = fused_photometric_forward(pred, target, 0.2)
    assert float(again[0]) == float(loss) and torch.equal(again[1], grad), \
        "two launches on the same inputs differ"
    del want_grad, again

    def resized(t):
        return torch.nn.functional.interpolate(
            t[None], size=(HEIGHT, WIDTH), mode="bilinear",
            align_corners=False)[0].clamp(0, 1).contiguous()

    big = (resized(pred), resized(target))
    _ssim_against_float64(*big, "natural view")
    gen = torch.Generator(device=pred.device).manual_seed(7)
    for shape in (pred.shape, big[0].shape):
        dark = [0.02 + 0.002 * torch.rand(tuple(shape), generator=gen,
                                          device=pred.device)
                for _ in range(2)]
        _ssim_against_float64(*dark, "dark image")
        _ssim_reference_contract(shape[1], shape[2])

    ms = time_ms(lambda: fused_photometric_forward(pred, target, 0.2), 50)
    big_ms = time_ms(lambda: fused_photometric_forward(*big, 0.2), 50)
    plain_ms = time_ms(lambda: fused_photometric_plain(pred, target, 0.2),
                       5)
    values = pred.numel()
    t_ops = SSIM_OPS_PER_VALUE * values / PEAK_FP32_FLOPS * 1e3
    t_bytes = 12 * values / PEAK_BYTES * 1e3
    big_bound = SSIM_OPS_PER_VALUE * big[0].numel() / PEAK_FP32_FLOPS * 1e3
    log(f"ssim: kernel {ms:.4f} ms at {pred.shape[2]}x{pred.shape[1]} "
        f"(before the redesign {K3_EARLIER_MS} ms), plain {plain_ms:.3f} "
        f"ms; bound {max(t_ops, t_bytes):.4f} ms (operations {t_ops:.4f}, "
        f"bytes {t_bytes:.4f}); at {WIDTH}x{HEIGHT} kernel {big_ms:.4f} ms, "
        f"bound {big_bound:.4f} ms")
    return {"name": "ssim", "route": "cuda",
            "source": "h3dgs_tpu_torch/csrc/ssim.cu",
            "replaces": "h3dgs_tpu/ops/pallas_ssim.py:99",
            "launches": launches, "max_abs_err": max(d_loss, d_grad),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "earlier_ms": K3_EARLIER_MS,
            "ms_1080p": big_ms}


def counted(fn, *args, **kw):
    """Run one path with every launch count reset just before and read just
    after. Returns (result, counts)."""
    from h3dgs_tpu_torch.ops import kernels

    kernels.reset_launches()
    result = fn(*args, **kw)
    torch.cuda.synchronize()
    return result, dict(kernels.LAUNCHES)


def training_phase(tmp: str, rng, look_at_camera):
    """Write the chunk, train through the CLI (plain loss, then fused),
    check the runs, then create the hierarchy from the trained point cloud
    and post-train it (``post_phase``). Returns (counts per path, K2
    inputs with a view's render and target for K3)."""
    from h3dgs_tpu_torch.config import OptimizationConfig
    from h3dgs_tpu_torch.io.meta import read_exposure_json
    from h3dgs_tpu_torch.io.ply import read_gaussian_ply
    from h3dgs_tpu_torch.scene.loader import load_view
    from h3dgs_tpu_torch.train.step import batch_to_device, encode_view

    t0 = time.perf_counter()
    src = os.path.join(tmp, "chunk")
    sc_dir = write_chunk(src, rng)
    log(f"training chunk written in {time.perf_counter() - t0:.1f} s: "
        f"{TRAIN_POINTS} points, {TRAIN_VIEWS} views {TRAIN_W}x{TRAIN_H}, "
        f"scaffold {SCAFFOLD_N} ({SCAFFOLD_SKY} skybox)")
    base = ["-s", src, "--scaffold_file", sc_dir, "--bounds_file", src,
            "--skybox_locked", "--depths", "depths", "--device",
            DEVICE] + TRAIN_FLAGS

    out = os.path.join(tmp, "model")
    t0 = time.perf_counter()
    rec, counts = counted(run_train_cli, base + [
        "-m", out, "--iterations", str(TRAIN_ITERS)])
    wall = time.perf_counter() - t0
    photo = rec["photo"]
    assert len(photo) == TRAIN_ITERS, len(photo)
    assert all(math.isfinite(x) for x in photo + rec["depth"]), photo
    first, last = np.mean(photo[:10]), np.mean(photo[-10:])
    log(f"train_single ({TRAIN_ITERS} iterations, {wall:.1f} s wall incl. "
        f"scene load): photo loss first 10 mean {first:.5f}, last 10 mean "
        f"{last:.5f}; kernel launches {counts}")
    assert last < first, (first, last)
    assert counts["blend_fwd"] >= TRAIN_ITERS and \
        counts["blend_bwd"] >= TRAIN_ITERS, counts
    steady = rec["step_ms"][4:]
    log(f"step time (CUDA events between step ends, iterations 6-"
        f"{TRAIN_ITERS}, densify and reset steps included): median "
        f"{np.median(steady):.3f} ms, min {np.min(steady):.3f}, max "
        f"{np.max(steady):.3f}; {1e3 / np.median(steady):.2f} it/s")
    state = rec["state"]
    log(f"final alive {int(state.n_alive)} of capacity {state.capacity}")
    for k in rec["locked0"]:
        assert torch.equal(rec["locked0"][k], rec["locked1"][k]), k
    log(f"locked skybox rows ({rec['n_locked']}) bit-equal to their "
        f"initial values")
    pc = os.path.join(out, "point_cloud", f"iteration_{TRAIN_ITERS}")
    g = read_gaussian_ply(os.path.join(pc, "point_cloud.ply"), 3)
    exp = read_exposure_json(os.path.join(out, "exposure.json"))
    assert g["xyz"].shape[0] > 0 and np.isfinite(g["xyz"]).all()
    assert len(exp) == TRAIN_VIEWS and all(np.isfinite(v).all()
                                           for v in exp.values())
    log(f"artifacts read back: point_cloud.ply {g['xyz'].shape[0]} rows, "
        f"exposure.json {len(exp)} views")

    # Per-stage split of one step on the final state.
    scene = rec["scene"]
    view = load_view(scene.info.train_cameras[0], -1)
    batch = batch_to_device(encode_view(view), DEVICE)
    stages, k2_inputs = train_stage_times(state, batch, 0,
                                          OptimizationConfig())
    log("train step stages (ms, CUDA events, mean of 5, one view): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    profile_steps(flat_step_runner(state, batch), "train step")
    del rec, scene, state

    out_f = os.path.join(tmp, "model_fused")
    rec_f, counts_f = counted(run_train_cli, base + [
        "-m", out_f, "--iterations", str(FUSED_ITERS)], fused=True)
    assert all(math.isfinite(x) for x in rec_f["photo"] + rec_f["depth"])
    log(f"train_single fused SSIM ({FUSED_ITERS} iterations): photo loss "
        f"first {rec_f['photo'][0]:.5f}, last {rec_f['photo'][-1]:.5f}, "
        f"median step {np.median(rec_f['step_ms'][4:]):.3f} ms; kernel "
        f"launches {counts_f}")
    assert counts_f["ssim"] >= FUSED_ITERS, counts_f
    del rec_f
    torch.cuda.empty_cache()
    post_counts = post_phase(tmp, out, src, sc_dir, look_at_camera)
    torch.cuda.empty_cache()
    eval_counts = eval_phase(tmp, out, src, sc_dir, look_at_camera)
    return ({"train": counts, "fused": counts_f, **post_counts,
             **eval_counts}, k2_inputs)


def post_phase(tmp: str, flat_out: str, src: str, sc_dir: str,
               look_at_camera):
    """Hierarchy creation from the flat run's point cloud, post-training
    through the CLI (plain loss with a checkpoint, a resumed run, the
    fused loss), the checks on what they wrote, and the post step's
    times. Returns the launch counts per path."""
    from h3dgs_tpu_torch.cli import hierarchy_creator
    from h3dgs_tpu_torch.config import OptimizationConfig
    from h3dgs_tpu_torch.hierarchy.io import read_anchors, read_hier
    from h3dgs_tpu_torch.scene.loader import load_view
    from h3dgs_tpu_torch.train.step import batch_to_device, encode_view
    from h3dgs_tpu_torch.viewer.service import HierarchyRenderer

    # --- hierarchy creation (host) ---
    ply = os.path.join(flat_out, "point_cloud", f"iteration_{TRAIN_ITERS}",
                       "point_cloud.ply")
    t0 = time.perf_counter()
    hierarchy_creator.main([ply, src, flat_out, sc_dir])
    seconds = time.perf_counter() - t0
    hier = os.path.join(flat_out, "hierarchy.hier")
    h0 = read_hier(hier)
    h0.validate()
    anchors = read_anchors(os.path.join(flat_out, "anchors.bin"))
    assert np.array_equal(anchors, h0.anchors)
    assert 0 < anchors.size < h0.n_nodes, anchors.size
    log(f"hierarchy_creator: {h0.n_nodes} nodes, {h0.n_leaves} leaves, "
        f"{anchors.size} anchors in {seconds:.1f} s (read, build on the "
        f"host, write)")

    # exposure.json of the flat run lies beside hierarchy.hier, so the
    # post step applies each view's trained exposure.
    base = ["-s", src, "--hierarchy", hier, "--scaffold_file", sc_dir,
            "--skybox_locked", "--device", DEVICE]
    out = os.path.join(tmp, "post")
    ckpt_it = POST_ITERS - POST_RESUMED
    t0 = time.perf_counter()
    rec, counts = counted(run_post_cli, base + [
        "-m", out, "--iterations", str(POST_ITERS),
        "--checkpoint_iterations", str(ckpt_it)])
    wall = time.perf_counter() - t0
    photo = rec["photo"]
    assert len(photo) == POST_ITERS, len(photo)
    assert all(math.isfinite(x) for x in photo), photo
    log(f"train_post ({POST_ITERS} iterations, {wall:.1f} s wall incl. "
        f"scene and hierarchy load): photo loss first 10 mean "
        f"{np.mean(photo[:10]):.5f}, last 10 mean {np.mean(photo[-10:]):.5f}"
        f"; kernel launches {counts}")
    assert counts["blend_fwd"] == POST_ITERS and \
        counts["blend_bwd"] == POST_ITERS and counts["ssim"] == 0, counts
    cuts = rec["cuts"]
    assert all(c == r == m for c, r, m in cuts), \
        "a post step rendered a truncated cut"
    log(f"cut sizes over the run: min {min(c for c, _, _ in cuts)}, max "
        f"{max(c for c, _, _ in cuts)} of {h0.n_nodes} nodes; every cut "
        f"rendered whole (reported size = rows rasterized less the skybox "
        f"= the cut mask's count, recomputed)")
    steady = rec["step_ms"][4:]
    log(f"post step time (CUDA events between step ends, iterations 6-"
        f"{POST_ITERS}): median {np.median(steady):.3f} ms, min "
        f"{np.min(steady):.3f}, max {np.max(steady):.3f}; "
        f"{1e3 / np.median(steady):.2f} it/s")
    state, locked = rec["state"], rec["locked"]
    moved = torch.zeros_like(locked)
    for k, v0 in rec["state0"].items():
        v1 = state.trainable_dict()[k]
        assert torch.equal(v0[locked], v1[locked]), f"locked rows of {k} moved"
        moved |= (v0 != v1).reshape(v0.shape[0], -1).any(dim=1)
    n_locked, n_moved = int(locked.sum()), int(moved.sum())
    log(f"locked rows ({n_locked}: {rec['n_anchor']} anchors, "
        f"{state.n_skybox} skybox) bit-equal to their initial values; "
        f"{n_moved} of the other {state.capacity - n_locked} rows changed")
    assert n_moved > (state.capacity - n_locked) // 4, n_moved

    # --- <hier>_opt: read back, validated, rendered ---
    h1 = read_hier(hier + "_opt")
    h1.validate()
    assert np.array_equal(h1.nodes, h0.nodes)
    m = h0.n_nodes
    assert np.array_equal(h1.xyz, state.xyz[:m].cpu().numpy())
    assert np.array_equal(h1.alpha,
                          state.opacity[:m, 0].abs().cpu().numpy())
    assert np.isfinite(h1.shs).all() and (h1.alpha >= 0).all()
    renderer = HierarchyRenderer(hier + "_opt", budget=BUDGET, device=DEVICE)
    frame, st = renderer.render(orbit_cams(look_at_camera)[0], SERVE_TAU)
    assert frame.shape == (HEIGHT, WIDTH, 3) and frame.max() > 0, frame.shape
    log(f"{os.path.basename(hier)}_opt: {h1.n_nodes} nodes read back and "
        f"validated; HierarchyRenderer frame {WIDTH}x{HEIGHT}, cut "
        f"{st['cut_size']}, mean level {frame.mean():.1f} / 255")
    del renderer

    # --- stages and busy share of one post step on the final state ---
    scene = rec["scene"]
    view = load_view(scene.info.train_cameras[0], -1)
    batch = batch_to_device(encode_view(view), DEVICE)
    nodes = torch.as_tensor(h0.nodes, device=DEVICE)
    boxes = torch.as_tensor(h0.boxes, device=DEVICE)
    amask = torch.as_tensor(scene.anchor_mask, device=DEVICE)
    exp_row = torch.eye(3, 4, device=DEVICE)
    limit = 0.02      # the middle of the sampled range, on the log scale
    stages, cut_size = post_stage_times(state, batch, nodes, boxes, amask,
                                        exp_row, limit, 0,
                                        OptimizationConfig())
    log(f"post step stages at limit {limit} (cut {cut_size}; ms, CUDA "
        f"events, mean of 5, one view): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    from h3dgs_tpu_torch.ops import adam as adam_lib
    from h3dgs_tpu_torch.ops.rasterize import RasterizeConfig
    from h3dgs_tpu_torch.train.post_step import make_post_train_step
    step = make_post_train_step(OptimizationConfig(), RasterizeConfig())
    opt = adam_lib.init(state.trainable_dict())
    bg = torch.zeros(3, device=DEVICE)
    profile_steps(lambda: step(state, opt, batch, nodes, boxes, amask,
                               exp_row, limit, 50, bg, 5.0, 0), "post step")
    del rec, scene, state, opt, step, batch

    # --- resumed from the checkpoint ---
    rec_r, counts_r = counted(run_post_cli, base + [
        "-m", out, "--iterations", str(POST_ITERS), "--start_checkpoint",
        os.path.join(out, f"chkpnt{ckpt_it}.npz")])
    assert len(rec_r["photo"]) == POST_RESUMED, len(rec_r["photo"])
    assert all(math.isfinite(x) for x in rec_r["photo"])
    assert counts_r["blend_fwd"] == POST_RESUMED and \
        counts_r["blend_bwd"] == POST_RESUMED, counts_r
    log(f"train_post resumed from chkpnt{ckpt_it}.npz: {POST_RESUMED} "
        f"iterations, photo loss {rec_r['photo'][0]:.5f} .. "
        f"{rec_r['photo'][-1]:.5f}; kernel launches {counts_r}")
    del rec_r

    # --- the fused loss ---
    rec_f, counts_f = counted(run_post_cli, base + [
        "-m", os.path.join(tmp, "post_fused"), "--iterations",
        str(POST_FUSED_ITERS)], fused=True)
    assert all(math.isfinite(x) for x in rec_f["photo"])
    assert all(c == r == m for c, r, m in rec_f["cuts"])
    log(f"train_post fused SSIM ({POST_FUSED_ITERS} iterations): photo "
        f"loss first {rec_f['photo'][0]:.5f}, last {rec_f['photo'][-1]:.5f}"
        f", median step {np.median(rec_f['step_ms'][4:]):.3f} ms; kernel "
        f"launches {counts_f}")
    assert counts_f == {"blend_fwd": POST_FUSED_ITERS,
                        "blend_bwd": POST_FUSED_ITERS,
                        "ssim": POST_FUSED_ITERS}, counts_f
    del rec_f
    return {"post": counts, "post_resumed": counts_r, "post_fused": counts_f}


def synthetic_lpips_weights(path: str, seed: int = 0) -> dict:
    """LPIPS(vgg) weights in the .npz layout, made from a seed: He-normal
    convolutions (so the features neither vanish nor blow up) and
    non-negative heads. Not the pretrained network: what they give is
    LPIPS(synthetic)."""
    from h3dgs_tpu_torch.eval.metrics import _VGG_CFG

    rng = np.random.default_rng(seed)
    arrays, cin, li = {}, 3, 0
    for block in _VGG_CFG:
        for cout in block:
            arrays[f"conv{li}.weight"] = rng.normal(
                0, np.sqrt(2.0 / (9 * cin)), (cout, cin, 3, 3)).astype(
                np.float32)
            arrays[f"conv{li}.bias"] = rng.normal(0, 0.01, cout).astype(
                np.float32)
            cin, li = cout, li + 1
    for i, block in enumerate(_VGG_CFG):
        arrays[f"lin{i}.weight"] = np.abs(rng.normal(
            0, 0.1, (1, block[-1], 1, 1))).astype(np.float32)
    np.savez(path, **arrays)
    return arrays


def run_eval_cli(argv):
    """``render_hierarchy.main(argv)`` with CUDA events around every
    ``render_cut`` (one per frame) and every metric call (PSNR, SSIM,
    LPIPS), and the first (frame, ground truth) pair LPIPS saw, with its
    value. Returns (results, per-frame ms of the render, of PSNR + SSIM
    and of LPIPS, (frame, ground truth, lpips))."""
    from h3dgs_tpu_torch.cli import render_hierarchy
    from h3dgs_tpu_torch.eval import metrics
    from h3dgs_tpu_torch.train import post_step

    events = {"render": [], "psnr": [], "ssim": [], "lpips": []}
    pair = []
    saved = {"render_cut": (post_step, post_step.render_cut),
             "psnr": (metrics, metrics.psnr),
             "ssim": (metrics, metrics.ssim),
             "lpips": (metrics, metrics.lpips)}

    def timed(key, fn):
        def wrapped(*a, **k):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            events[key].append(ev)
            if fn is saved["lpips"][1] and not pair:
                pair.append((a[0].clone(), a[1].clone(), out))
            return out
        return wrapped

    for name, (mod, fn) in saved.items():
        setattr(mod, name, timed("render" if name == "render_cut" else name,
                                 fn))
    try:
        results = render_hierarchy.main(argv)
        torch.cuda.synchronize()
    finally:
        for name, (mod, fn) in saved.items():
            setattr(mod, name, fn)
    ms = {k: np.asarray([a.elapsed_time(b) for a, b in evs])
          for k, evs in events.items()}
    assert len({len(v) for v in ms.values()}) == 1, \
        {k: len(v) for k, v in ms.items()}
    return results, ms["render"], ms["psnr"] + ms["ssim"], ms["lpips"], \
        pair[0]


def lpips_tf32_check(weights_path: str, weights: dict, frame, gt):
    """The card's LPIPS of one (frame, ground truth) pair at the eval's
    size against the same network in float64 on the CPU, within LPIPS_REL;
    the same distance on the card with cuDNN's TF32 allowed, which must
    land beyond LPIPS_REL (else the limit could not tell TF32 from
    float32); the frame against itself."""
    from h3dgs_tpu_torch.eval import metrics

    cudnn = torch.backends.cudnn
    tf32_before = cudnn.allow_tf32
    card = metrics.lpips(frame, gt, weights_path=weights_path, device=DEVICE)
    assert cudnn.allow_tf32 == tf32_before, "lpips left TF32 changed"
    same = metrics.lpips(frame, frame, weights_path=weights_path,
                         device=DEVICE)
    net = metrics.LPIPSNet(weights).to(DEVICE)
    x = torch.stack([frame, gt]).float() * 2.0 - 1.0
    with torch.no_grad(), cudnn.flags(
            enabled=cudnn.enabled, benchmark=cudnn.benchmark,
            deterministic=cudnn.deterministic, allow_tf32=True):
        tf32 = float(net.distance(net.features(x)))
    del net, x
    t0 = time.perf_counter()
    net64 = metrics.LPIPSNet(weights).double()
    with torch.no_grad():
        want = float(net64(frame.cpu().double(), gt.cpu().double()))
    rel, rel_tf32 = (abs(v - want) / want for v in (card, tf32))
    log(f"lpips on the card vs float64 on the CPU ({frame.shape[2]}x"
        f"{frame.shape[1]}, view 0 at tau {EVAL_TAUS[0]}): {card:.10f} vs "
        f"{want:.10f}, relative |d| {rel:.3e}; with TF32 allowed "
        f"{tf32:.10f}, relative |d| {rel_tf32:.3e} (limit {LPIPS_REL:g} "
        f"between them); frame against itself {same:.3e}; float64 "
        f"reference {time.perf_counter() - t0:.1f} s on the host")
    assert rel <= LPIPS_REL, (card, want)
    assert rel_tf32 > LPIPS_REL, ("the limit does not tell TF32 from "
                                  "float32", tf32, want)
    assert abs(same) < 1e-6, same


def render_check(merged_path: str, sc_dir: str, exposure_path: str,
                 look_at_camera):
    """The flat entry point ``render.render`` on the card at full width:
    ``merged.hier``'s state with the scaffold's skybox rows, its leaves and
    skybox rows as an exact index subset, view 0 at 1600x900 with its
    pretrained exposure; counted (one K1 launch). Held against
    ``rasterize`` of the same rows gathered here, the exposure applied in
    float64 and the image clipped: within RENDER_EXPOSURE_TOL; visibility
    and radii equal on the subset and zero off it. Returns the launch
    counts."""
    from h3dgs_tpu_torch import render as render_lib
    from h3dgs_tpu_torch.hierarchy.io import read_hier
    from h3dgs_tpu_torch.hierarchy.tree import N_CHILDREN
    from h3dgs_tpu_torch.io import meta as meta_io
    from h3dgs_tpu_torch.model.init import state_from_hierarchy
    from h3dgs_tpu_torch.ops.rasterize import rasterize

    h = read_hier(merged_path)
    state, _ = state_from_hierarchy(h, sc_dir, device=DEVICE)
    cap, n_sky = state.capacity, state.n_skybox
    rows = np.concatenate([np.flatnonzero(h.nodes[:, N_CHILDREN] == 0),
                           np.arange(cap - n_sky, cap)])
    idx = torch.as_tensor(rows, device=DEVICE)
    exposures = meta_io.read_exposure_json(exposure_path)
    name = min(exposures)
    assert name.startswith("view_000"), name
    exposure = torch.as_tensor(exposures[name], dtype=torch.float32,
                               device=DEVICE)
    cam = train_cameras(look_at_camera)[0]
    bg = torch.zeros(3, device=DEVICE)
    t0 = time.perf_counter()
    with torch.no_grad():
        out, counts = counted(render_lib.render, cam, state, bg,
                              use_trained_exp=True, exposure=exposure,
                              indices=idx, device=DEVICE)
        wall_ms = (time.perf_counter() - t0) * 1e3
        ref = rasterize(state.xyz[idx], state.get_scaling()[idx],
                        state.get_rotation()[idx],
                        state.get_opacity()[idx, 0],
                        state.get_features(state.max_sh_degree)[idx], cam,
                        state.max_sh_degree, bg)
    # The reference's exposure multiplies each pixel's colour, a row
    # vector, by the 3x3 part: out_j = sum_i rgb_i * e[i, j] + e[j, 3].
    e = exposure.double()
    want = (torch.einsum("ij,ihw->jhw", e[:, :3], ref["render"].double())
            + e[:, 3, None, None]).clamp(0.0, 1.0)
    d = float((out["render"].double() - want).abs().max())
    vis, radii = out["visibility_filter"], out["radii"]
    n_vis = int(vis.sum())
    log(f"render.render on the card: {rows.size} of {cap} rows (merged "
        f"leaves and skybox) as an exact subset, view 0 {TRAIN_W}x{TRAIN_H} "
        f"with its exposure, {wall_ms:.1f} ms wall; max |d| from rasterize "
        f"of the rows gathered here, exposure in float64, {d:.3e}; {n_vis} "
        f"visible, visibility and radii equal on the subset and zero off "
        f"it; kernel launches {counts}")
    assert counts == {"blend_fwd": 1, "blend_bwd": 0, "ssim": 0}, counts
    assert tuple(out["render"].shape) == (3, TRAIN_H, TRAIN_W)
    assert d <= RENDER_EXPOSURE_TOL, d
    assert float(out["render"].min()) >= 0 and float(out["render"].max()) <= 1
    assert torch.equal(vis[idx], ref["visibility_filter"]), "visibility"
    assert torch.equal(radii[idx], ref["radii"].to(radii.dtype)), "radii"
    assert n_vis == int(vis[idx].sum()) > 0, n_vis
    assert int((radii != 0).sum()) == int((radii[idx] != 0).sum())
    return counts


def merge_check(hier_opt: str, tmp: str) -> str:
    """Two chunk directories whose boxes split the training chunk's at
    X = 0, each holding ``hier_opt``; the port's merger CLI on them; the
    merged tree against a leaf count made here with numpy. Returns the
    merged file's path."""
    from h3dgs_tpu_torch.cli import hierarchy_merger
    from h3dgs_tpu_torch.hierarchy.io import read_hier
    from h3dgs_tpu_torch.hierarchy.tree import N_CHILDREN
    from h3dgs_tpu_torch.io import meta as meta_io

    trained = os.path.join(tmp, "trained_chunks")
    chunks = os.path.join(tmp, "chunks")
    half = CHUNK_EXTENT / 2
    bounds = {}
    for name, cx in (("x_neg", -half / 2), ("x_pos", half / 2)):
        os.makedirs(os.path.join(trained, name))
        os.makedirs(os.path.join(chunks, name))
        os.symlink(hier_opt, os.path.join(trained, name,
                                          "hierarchy.hier_opt"))
        center = [cx, 0.0, 0.0]
        extent = [half, CHUNK_EXTENT, CHUNK_EXTENT]
        meta_io.write_vec(os.path.join(chunks, name, "center.txt"), center)
        meta_io.write_vec(os.path.join(chunks, name, "extent.txt"), extent)
        c, e = np.float32(center), np.float32(extent)
        bounds[name] = (c - e / 2, c + e / 2)
    merged_dir = os.path.join(tmp, "merged")
    merged_path = os.path.join(merged_dir, "merged.hier")
    t0 = time.perf_counter()
    hierarchy_merger.main([trained, "0", chunks, merged_path,
                           *sorted(bounds)])
    seconds = time.perf_counter() - t0

    h = read_hier(hier_opt)
    m = read_hier(merged_path)
    m.validate()
    assert m.root == 0 and m.nodes[0, N_CHILDREN] == 2, m.nodes[0]

    def inside(xyz, lo, hi):
        return ((xyz[:, 0] >= lo[0]) & (xyz[:, 0] <= hi[0])
                & (xyz[:, 1] >= lo[1]) & (xyz[:, 1] <= hi[1]))

    leaf = h.nodes[:, N_CHILDREN] == 0
    want = sum(int((leaf & inside(h.xyz, lo, hi)).sum())
               for lo, hi in bounds.values())
    assert m.n_leaves == want, (m.n_leaves, want)
    m_leaf = m.nodes[:, N_CHILDREN] == 0
    union = np.zeros(m.n_nodes, bool)
    for lo, hi in bounds.values():
        union |= inside(m.xyz, lo, hi)
    assert union[m_leaf].all(), "a merged leaf lies outside both boxes"
    log(f"hierarchy_merger: 2 chunks of {h.n_nodes} nodes ({h.n_leaves} "
        f"leaves each) -> {m.n_nodes} nodes, {m.n_leaves} leaves (= the "
        f"leaves inside the two half boxes, counted with numpy), "
        f"{m.anchors.size} anchors, validated, in {seconds:.1f} s on the "
        f"host (read, prune, merge, write)")
    return merged_path


def eval_phase(tmp: str, flat_out: str, src: str, sc_dir: str,
               look_at_camera):
    """README steps 4-5 on the post phase's output: merge two chunks of
    its ``hierarchy.hier_opt`` (2,174,263 nodes each), serve one frame of
    ``merged.hier`` and render it once through the flat entry point
    ``render.render`` (``render_check``), then ``render_hierarchy.main``
    over the chunk's views at 1600x900 for every tau of EVAL_TAUS,
    counted, with the flat run's exposures and the scaffold's skybox
    rows. Images are not written
    (``--no_images``): the PNG writer is the training chunk's, and the CPU
    tests compare its files with the JAX package's. Returns the launch
    counts of the evaluation and of the render."""
    import shutil

    from h3dgs_tpu_torch.eval import metrics
    from h3dgs_tpu_torch.viewer.service import HierarchyRenderer

    merged_path = merge_check(
        os.path.join(flat_out, "hierarchy.hier_opt"), tmp)
    shutil.copyfile(os.path.join(flat_out, "exposure.json"),
                    os.path.join(os.path.dirname(merged_path),
                                 "exposure.json"))

    # --- serve ---
    renderer = HierarchyRenderer(merged_path, budget=BUDGET, device=DEVICE)
    frame, st = renderer.render(orbit_cams(look_at_camera)[0], SERVE_TAU)
    assert frame.shape == (HEIGHT, WIDTH, 3) and frame.max() > 0, \
        "merged.hier frame is black"
    log(f"merged.hier served: HierarchyRenderer frame {WIDTH}x{HEIGHT} at "
        f"tau {SERVE_TAU}, cut {st['cut_size']}, mean level "
        f"{frame.mean():.1f} / 255")
    del renderer
    torch.cuda.empty_cache()
    render_counts = render_check(
        merged_path, sc_dir,
        os.path.join(os.path.dirname(merged_path), "exposure.json"),
        look_at_camera)
    torch.cuda.empty_cache()

    # --- evaluate, counted ---
    weights_path = os.path.join(tmp, "lpips_synthetic.npz")
    weights = synthetic_lpips_weights(weights_path)
    log("LPIPS below is LPIPS(synthetic): seeded He-normal VGG16 weights, "
        "not the pretrained network (no weights are in the repository)")
    old_env = os.environ.get(metrics.LPIPS_WEIGHTS_ENV)
    os.environ[metrics.LPIPS_WEIGHTS_ENV] = weights_path
    argv = ["-s", src, "--hierarchy", merged_path, "--scaffold_file",
            sc_dir, "-m", os.path.join(tmp, "eval"), "--no_images",
            "--device", DEVICE, "--taus", *(str(t) for t in EVAL_TAUS)]
    t0 = time.perf_counter()
    try:
        (results, render_ms, ps_ms, lpips_ms, pair), counts = counted(
            run_eval_cli, argv)
    finally:
        if old_env is None:
            os.environ.pop(metrics.LPIPS_WEIGHTS_ENV)
        else:
            os.environ[metrics.LPIPS_WEIGHTS_ENV] = old_env
    wall = time.perf_counter() - t0
    n_frames = TRAIN_VIEWS * len(EVAL_TAUS)
    log(f"render_hierarchy ({TRAIN_VIEWS} views {TRAIN_W}x{TRAIN_H} x "
        f"{len(EVAL_TAUS)} taus = {n_frames} frames, {wall:.1f} s wall incl."
        f" scene and hierarchy load and PNG decoding); kernel launches "
        f"{counts}")
    assert counts == {"blend_fwd": n_frames, "blend_bwd": 0, "ssim": 0}, \
        counts
    assert len(render_ms) == n_frames
    cut_means = []
    for i, tau in enumerate(EVAL_TAUS):
        r = results[tau]
        sl = slice(i * TRAIN_VIEWS, (i + 1) * TRAIN_VIEWS)
        log(f"eval tau={tau:4.1f}: PSNR {r['psnr']:.4f} dB, SSIM "
            f"{r['ssim']:.6f}, LPIPS(synthetic) {r['lpips']:.6f}, cut mean "
            f"{r['cut_mean']:.0f} (min {r['cut_min']}, max {r['cut_max']}) "
            f"over {r['n_views']} views; per frame (CUDA events) render "
            f"{np.mean(render_ms[sl]):.3f} ms, PSNR + SSIM "
            f"{np.mean(ps_ms[sl]):.3f} ms, LPIPS {np.mean(lpips_ms[sl]):.3f}"
            f" ms")
        assert r["n_views"] == TRAIN_VIEWS
        assert all(math.isfinite(r[k]) for k in ("psnr", "ssim", "lpips")), r
        cut_means.append(r["cut_mean"])
    assert all(b <= a for a, b in zip(cut_means, cut_means[1:])), cut_means
    lpips_tf32_check(weights_path, weights, pair[0], pair[1])
    del pair
    return {"eval": counts, "render": render_counts}


def write_orchestration_project(proj: str, rng, look_at_camera):
    """A two-chunk project in the full_train layout at a reduced size:
    ``camera_calibration/aligned`` (COLMAP model and PNG views of the
    surface, ORCH_POINTS points) and ``camera_calibration/chunks/{c0,c1}``
    (the same model, and bounds splitting the surface at X = 0)."""
    import shutil

    from h3dgs_tpu_torch.io import colmap as colmap_io
    from h3dgs_tpu_torch.io import meta as meta_io

    xyz, shs, alpha, scaling, rotation = make_scene(rng, ORCH_POINTS)
    aligned = os.path.join(proj, "camera_calibration", "aligned")
    sparse = os.path.join(aligned, "sparse", "0")
    os.makedirs(os.path.join(aligned, "images"))
    gt = [torch.as_tensor(a, device=DEVICE)
          for a in (xyz, np.exp(scaling), rotation, alpha, shs)]
    cameras = [look_at_camera(eye=(5 * np.sin(a), -1.5, -5 * np.cos(a)),
                              target=(0.0, 0.0, 0.0), fovx=1.2,
                              width=ORCH_W, height=ORCH_H)
               for a in np.linspace(0, 2 * np.pi, ORCH_VIEWS,
                                    endpoint=False)]
    cams, imgs, _ = write_views(aligned, cameras, gt, depths=False)
    del gt
    colmap_io.write_model_binary(sparse, cams, imgs,
                                 colmap_points(xyz, shs, rng))
    for name, cx in (("c0", -1.5), ("c1", 1.5)):
        chunk = os.path.join(proj, "camera_calibration", "chunks", name)
        shutil.copytree(os.path.join(aligned, "sparse"),
                        os.path.join(chunk, "sparse"))
        meta_io.write_vec(os.path.join(chunk, "center.txt"), [cx, 0.0, 0.0])
        meta_io.write_vec(os.path.join(chunk, "extent.txt"), [3.0, 6.0, 6.0])
    return os.path.join(aligned, "images")


def run_process_tree(cmd, timeout: float) -> str:
    """Run ``cmd`` as the leader of a new process group, from the
    repository's root; on a timeout kill the whole group (its child
    processes too) and raise. Returns its output (standard error
    merged); raises with the output's end when it fails."""
    import signal

    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[:4]} exited {proc.returncode}:\n"
                           + out[-4000:])
    return out


def orchestrate_phase(tmp: str, rng, look_at_camera) -> None:
    """``python -m h3dgs_tpu_torch.cli.full_train`` as a child process on
    the card over a two-chunk project written here at a reduced size
    (ORCH_POINTS Gaussians on the serving surface, 20,000 in each chunk's
    half, ORCH_VIEWS views at ORCH_W x ORCH_H, ORCH_ITERS iterations of
    coarse, single and post training, no skybox), then again with
    ``--skip_if_exists``. Checks the orchestration: every child a module of
    the port, both chunks trained and merged, nothing re-run by the second
    call but the merger."""
    from h3dgs_tpu_torch.hierarchy.io import read_hier
    from h3dgs_tpu_torch.hierarchy.tree import N_CHILDREN

    proj = os.path.join(tmp, "project")
    t0 = time.perf_counter()
    images = write_orchestration_project(proj, rng, look_at_camera)
    log(f"full_train project written in {time.perf_counter() - t0:.1f} s: "
        f"2 chunks, {ORCH_POINTS} points, {ORCH_VIEWS} views "
        f"{ORCH_W}x{ORCH_H}")
    cmd = [sys.executable, "-m", "h3dgs_tpu_torch.cli.full_train",
           "--project_dir", proj, "--images_dir", images,
           "--iterations", str(ORCH_ITERS), "--extra_training_args",
           f"--iterations {ORCH_ITERS} --skybox_num 0 "
           f"--capacity_factor 2.0"]
    out_dir = os.path.join(proj, "output")
    opt = {c: os.path.join(out_dir, "trained_chunks", c, "hierarchy.hier_opt")
           for c in ("c0", "c1")}
    merged_path = os.path.join(out_dir, "merged.hier")

    t0 = time.perf_counter()
    said = run_process_tree(cmd, ORCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    children = [ln[2:] for ln in said.splitlines() if ln.startswith("+ ")]
    assert len(children) == 8, children      # coarse, 2 x 3 stages, merger
    assert all(" -m h3dgs_tpu_torch.cli." in c for c in children), children
    merged = read_hier(merged_path)
    merged.validate()
    assert merged.nodes[0, N_CHILDREN] == 2, merged.nodes[0]
    before = {c: os.path.getmtime(p) for c, p in opt.items()}
    modules = sorted({c.split(" -m ")[1].split()[0] for c in children})
    log(f"full_train on the card: {len(children)} child processes, every "
        f"one a module of the port ({', '.join(modules)}); merged.hier "
        f"{merged.n_nodes} nodes, {merged.n_leaves} leaves, validated; "
        f"{wall:.1f} s wall")

    t0 = time.perf_counter()
    said = run_process_tree(cmd + ["--skip_if_exists"], ORCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    children = [ln[2:] for ln in said.splitlines() if ln.startswith("+ ")]
    assert len(children) == 1 and \
        " -m h3dgs_tpu_torch.cli.hierarchy_merger " in children[0], children
    assert {c: os.path.getmtime(p) for c, p in opt.items()} == before, \
        "--skip_if_exists re-ran a chunk"
    read_hier(merged_path).validate()
    log(f"full_train --skip_if_exists: no chunk re-run (hierarchy.hier_opt "
        f"mtimes unchanged), merger only; {wall:.1f} s wall")


def build_kernels() -> None:
    """Every kernel from its source, one nvcc each, started together; the
    compiler's register / spill report."""
    from h3dgs_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    build_s = kernels.build()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in build_s.items())})")
    for name in kernels.SOURCES:
        what = name
        with open(kernels.library_path(name) + ".log") as f:
            for line in f:
                if "Function properties for" in line:
                    what = (f"{name} (pack pre-pass)"
                            if "pack_kernel" in line else name)
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {what}: {line.strip()}")
    for name in ("blend_fwd", "blend_bwd"):
        blocks, threads = kernels.occupancy(name)
        log(f"  occupancy {name}: {blocks} resident blocks per SM of "
            f"{threads} threads ({blocks * threads // 32} of 64 warps)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    log(card_line())
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from h3dgs_tpu_torch.hierarchy.io import write_hier
    from h3dgs_tpu_torch.hierarchy.tree import build_hierarchy
    from h3dgs_tpu_torch.scene.camera import look_at_camera
    from h3dgs_tpu_torch.viewer.service import HierarchyRenderer, serve

    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    build_kernels()

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    h = build_hierarchy(*make_scene(rng, N_LEAVES))
    log(f"hierarchy build: {N_LEAVES} leaves -> {h.n_nodes} nodes in "
        f"{time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "merged.hier")
        t0 = time.perf_counter()
        write_hier(path, h)
        del h
        renderer = HierarchyRenderer(path, budget=BUDGET, device=DEVICE)
        torch.cuda.synchronize()
        log(f"write + open hierarchy: {time.perf_counter() - t0:.1f} s")

    cams = orbit_cams(look_at_camera)

    # --- the serving path, counted ---
    (frames, served), launches = counted(main_path, renderer, cams,
                                         look_at_camera, serve)
    log(f"serving path: {frames} frames, kernel launches {launches}")
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
    args, height, width = inputs
    k1_row = check_blend(args, height, width, 0)
    del renderer, inputs, args
    torch.cuda.empty_cache()

    # --- the training paths, counted ---
    with tempfile.TemporaryDirectory() as tmp:
        train_counts, k2_inputs = training_phase(tmp, rng, look_at_camera)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        orchestrate_phase(tmp, rng, look_at_camera)
    steps = (TRAIN_ITERS + FUSED_ITERS + POST_ITERS + POST_RESUMED
             + POST_FUSED_ITERS)
    fused_steps = FUSED_ITERS + POST_FUSED_ITERS
    eval_frames = TRAIN_VIEWS * len(EVAL_TAUS)
    total = {k: launches[k] + sum(c[k] for c in train_counts.values())
             for k in launches}
    log(f"kernel launches over the {1 + len(train_counts)} paths: {total} "
        f"({frames} frames, {steps} training steps, {fused_steps} of them "
        f"with the fused loss, {eval_frames} evaluation frames, 1 render "
        f"call)")
    assert total["blend_fwd"] >= frames + steps + eval_frames + 1, total
    assert total["blend_bwd"] >= steps, total
    assert total["ssim"] >= fused_steps, total
    for name, n in total.items():
        assert n > 0, f"kernel {name} was not launched on the main paths"

    # --- kernels against their plain versions (not counted) ---
    k1_row["launches"] = total["blend_fwd"]
    rows = [k1_row, check_blend_bwd(k2_inputs, total["blend_bwd"]),
            check_ssim(k2_inputs[8], k2_inputs[9], total["ssim"])]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"peak device memory allocated: {peak_gb:.2f} GB")

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
