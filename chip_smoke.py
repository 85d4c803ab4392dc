#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port: the serving path (with
pixel bands and the browser viewer), the per-chunk training path (one and
four views a step), the hierarchy post-training path (one and four views
a step), the merger, the evaluation, the orchestrator and preprocessing.

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
reduced size, then again with ``--skip_if_exists``. Several views a
step: the chunk trained through ``train_single --views_per_step 4`` (40
iterations, then 10 with the fused loss) and the hierarchy post-trained
through ``train_post --views_per_step 4`` (20 iterations); pixel bands of
the serving frame; ``WebViewer`` over HTTP; both hierarchy backends (C++,
built from ``native/hierarchy_native.cpp``, and numpy) for creation and
merging; the trained state through the packed ``.pt`` format.
Preprocessing (README steps 1-3): a synthetic aligned project of 1,200
views at 1600x900 over a 300 m square and 1.5M ground points, chunked by
``python -m h3dgs_tpu_torch.preprocess.drivers chunks`` on the card,
calibrated by ``drivers depth`` against 240 known inverse-depth maps,
masked by both mask tools, each held against the CPU path, then the host
modules at that size, and ``masks black`` on JPEG copies of masked views.
JPEG: the committed fixtures of ``tests/data/torch_jpeg`` (the card's
machine has no PIL or OpenCV; baseline and progressive) decoded by the
port's own decoder and re-encoded by its own encoder against their
manifest's digests, the training chunk trained on its 24 views read from
the 1600x900 JPEG fixture, from its progressive twin and from its PNG
twin, and the host's decode and encode rates; the browser viewer's
frames are the port's JPEGs. Views as the JAX package sees them: the
committed fixtures of ``tests/data/torch_png`` (every PNG kind, Adam7
included, under the five read contracts of the JAX package's callers,
and OpenCV's INTER_AREA resize cases) against their manifest, the
training chunk trained on its views enlarged to 2000x1125 (shrunk by
1.25 at load) with 1-bit and palette masks and half-size depth maps (one
gray+alpha, one missing), and on 4032x3024 views, with ``load_view``'s
rate on those against the old area pooling.

Phases, each failing the run with its traceback:
  1. card name and power limit (nvidia-smi); fails without CUDA;
  2. build every kernel from ``h3dgs_tpu_torch/csrc`` (one nvcc each,
     started together);
  3. build and write the hierarchy, open the renderer;
  4. the serving path, with launch counts reset just before and read just
     after: renderer frames for every tau, then 3 socket requests through
     ``serve()`` whose replies are checked against ``renderer.render``;
  5. per-stage times with CUDA events (select, interpolate, project, bin,
     blend kernel, total) at each tau; then, counted, the tau-0 cut in 2
     and 4 pixel bands (``render_banded`` on repeated ``cuda`` devices:
     bit-equal to the full frame, K1 once per band) and 3 ``/frame``
     requests to ``WebViewer`` (JPEGs byte-equal to ``encode_jpeg`` of
     ``renderer.render`` at q 85 and one other q, decoded back; the
     encode's one-thread ms at 1080p);
  6. write the training chunk;
  7. the training path, counted the same way: ``train_single.main`` for 80
     iterations; loss finite and falling, artifacts written and read back,
     locked skybox rows unchanged; step time and its per-stage split;
     then JPEG: every fixture, baseline and progressive, decoded by the
     C++ decoder to its PIL digest (and OpenCV's, through ``load_bgr8``,
     where the EXIF orientation turns it; the plain version bit-equal
     below 300x300; the one with unfinished progressive scans refused)
     and re-encoded at 7 qualities to PIL's bytes' digests,
     ``train_single`` counted for 30 iterations on the 24 views as hard
     links to the 1600x900 fixture (named ``.jpg`` in images.bin; losses
     finite, K1 and K2 once per step), on its progressive twin (the same
     pixels) and on its PNG twin (medians side by side), and the decode
     rates at 1600x900: one thread, ``load_view`` in 8 threads and the
     Laplacian pass; the encode's one-thread ms at 1600x900;
     then the views phase: every PNG fixture under five contracts at its
     manifest digest (C++ and plain unfilter) and every resize case at
     its tolerance (C++ and plain), ``train_single`` counted for 30
     iterations on 2000x1125 views with 1-bit and palette masks and
     half-size depths (one gray+alpha, one missing; each view loaded back
     and checked), ``load_view`` views/s in 8 threads on 4032x3024 PNG
     and JPEG views with ``resize_area`` and with the old pooling, and
     ``train_single`` counted for 30 iterations on 4032x3024 views, its
     median step beside the 1600x900 PNG views';
  8. a 4-view dp step's gradients against the mean of 4 single-view
     gradients; the busy share of a 4-view step; the trained state saved
     and loaded in the ``.pt`` format; the fused-loss training path,
     counted: 20 iterations with ``H3DGS_FUSED_SSIM=1``; then 4 views a
     step, counted: 40 iterations (loss falling, locked rows bit-equal,
     K1 and K2 once per view, views/s against one view a step) and 10
     with the fused loss (K3 once per view);
  9. hierarchy creation from the trained point cloud with both backends
     (structure equal, leaves equal as a set); the post-training paths,
     counted: 60 iterations (the step after the checkpoint write timed on
     its own), 20 with the fused loss, a resumed run, 20 iterations of 4
     views a step; locked rows bit-equal, no cut truncated,
     ``<hier>_opt`` read back, validated and rendered; the post step's
     time, stages and busy share;
 10. the evaluation path, counted: merge with both backends (validated,
     leaves counted independently), one served frame of ``merged.hier``, the tau sweep
     (K1 once per frame, metrics finite, cuts coarsening with tau, per-
     frame render and metric times), LPIPS on the card against float64
     on the CPU;
 11. ``full_train`` in child processes on the card, and its resume;
     then preprocessing: the project written (its images as libpng
     filters them, each texture decoded back), ``drivers chunks`` in a
     child process (chunks.txt, camera counts, no points in image
     records, no blurred view, boxes respected, no point in two chunks,
     and ``make_chunks(device="cpu")`` byte-equal), ``drivers depth``
     (every view with a map recovers its 1/a and -b/a, the CPU path
     within 1e-6), ``masks uint8`` and ``masks black`` bit-equal to the
     CPU path, ``masks black`` on 8 JPEG views byte-equal to
     ``encode_jpeg`` of the masked pixels at 95, and ``auto_reorient``,
     ``simplify_images``, the distance matcher, ``fill_database`` and ``transform_colmap`` against a known
     sim(3) (points and camera centres within 1e-9, each quaternion the
     composed rotation's), the Laplacian pass's images/s on the
     project's files and on the same samples with filter None, each
     step's wall time logged (no kernel runs here);
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
# Pixel bands of the serving frame on repeated devices of the one card,
# and the browser viewer's frames.
BAND_COUNTS = (2, 4)
N_WEB = 3
WEB_OTHER_Q = 60                # the quality of the last web frame

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

# K4, the projection: bytes a row at SH degree 3 (csrc/project.cu's
# note): the forward reads 236 and writes 41, the backward reads 268 and
# writes 232. Shapes: the flat step's rows below the store's mark in the
# benchmark's train_chunk (about 1.10M of 8.1M), and a serving cut of the
# two-chunk hierarchy (about 2M rows).
PROJ_FWD_BYTES = 236 + 41
PROJ_BWD_BYTES = 268 + 232
PROJ_STEP_ROWS = 1_100_000
PROJ_SERVE_ROWS = 2_000_000
# The kernel's conic against the plain version's on the card, each
# element: the plain version's quaternion norm is a torch.sum, whose
# order of additions the kernel follows as the card's torch takes it
# (another order moves ill-conditioned rows' conics by up to 7e-4); the
# other outputs are held equal. Gradients: the
# kernel's closed form against autograd of the plain version, both
# float32: max |d| within PROJ_GRAD_TOL_REL of max |g| and cosine at least
# BWD_MIN_COSINE.
PROJ_CONIC_REL = 1e-4
PROJ_GRAD_TOL_REL = 1e-3

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
# Several views a step (parallel/step.py) on the same chunk and hierarchy:
# DP_VIEWS views a step, DP_ITERS flat iterations, DP_FUSED_ITERS with the
# fused loss, DP_POST_ITERS post iterations.
DP_VIEWS = 4
DP_ITERS = 40
DP_FUSED_ITERS = 10
DP_POST_ITERS = 20
# The dp step's accumulated gradients against the float64 mean of the
# views' single-view gradients, per group, relative to the group's largest
# value. K2 sums each Gaussian's gradient with float atomics whose order
# changes from launch to launch (the kernel check below allows BWD_TOL_REL
# = 1e-3 per output against the plain version; launches of the same
# inputs measured within 4.4e-5 of the largest value, PERF.md); four
# float32 additions add a few ulps.
ACCUM_TOL = 1e-4
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
# Preprocessing (README steps 1-3) on a seeded synthetic aligned project
# written with the port's own writers: PRE_CAMS PINHOLE views at PRE_W x
# PRE_H on a jittered grid over a PRE_AREA m square, 25-40 m up, looking
# down and forward at varied headings; PRE_POINTS SfM points on the ground
# plane (some with errors that the chunker's error < 10 filter drops),
# each view keeping up to PRE_MAX_VISIBLE of the points in its frame and
# a few -1 ids; PRE_TEXTURES textured images and PRE_BLURRED heavily
# blurred ones hard-linked under the views' names; PRE_TEST test views;
# 16-bit inverse-depth maps at half resolution for PRE_DEPTH_VIEWS views,
# each the view's own plane geometry times a known a plus b; PRE_MASKS
# RGBA masks at half resolution.
PRE_CAMS = 1200
PRE_W, PRE_H = 1600, 900
PRE_FOCAL = 1200.0
PRE_AREA = 300.0
PRE_POINTS = 1_500_000
PRE_MAX_VISIBLE = 4000
PRE_TEXTURES, PRE_BLURRED = 24, 4
PRE_TEST = 20
PRE_DEPTH_VIEWS = 240
PRE_MASKS = 200
PRE_JPEG_MASKED = 8             # masked views also given as JPEG copies
PRE_CHUNK = 100.0
PRE_MIN_CAMS = 100
PRE_MAX_CAMS = 200
PRE_TIMEOUT_S = 600
# Views timed on their own for the Laplacian pass's rates.
PRE_RATE_VIEWS = 120
# The JPEG phase: the committed fixtures (``tests/data/torch_jpeg``, made
# with PIL and OpenCV by ``scripts/torch_make_jpeg_fixtures.py``; the card's
# machine has neither) and their manifest of PIL's and OpenCV's digests;
# the training chunk's views as hard links to the 1600x900 fixture.
JPEG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data", "torch_jpeg")
JPEG_VIEW = "view_420_1600x900.jpg"
JPEG_PROGRESSIVE_VIEW = "view_420_1600x900_progressive.jpg"
JPEG_PLAIN_MAX = 300 * 300      # the plain decoder runs below this area
JPEG_ITERS = 30
JPEG_DECODE_REPS = 10
JPEG_LOADER_VIEWS = 120         # load_view calls per rate, in 8 threads
PNG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "data", "torch_png")
VIEWS_ITERS = 30
VIEWS_W, VIEWS_H = 2000, 1125   # -r -1 shrinks them by 1.25 to 1600x900
BIG_W, BIG_H = 4032, 3024       # a phone's photograph
VIEWS_LOADER = 24               # load_view calls per rate, in 8 threads
# The calibration recovers 1/a and -b/a up to the maps' 16-bit rounding
# (1.5e-5 against values spread over ~0.3) and the replicated border
# column; the CPU path's samples differ from the card's by FMA rounding
# only; a known sim(3) brings the points and the camera centres back to
# float64 rounding, and transform_colmap writes the quaternion of the
# rotation it composes: rotmat2qvec's float32 values, equal to the check's
# own to two float32 units in the last place at 1.
PRE_DEPTH_TOL = 1e-3
PRE_CPU_TOL = 1e-6
PRE_SIM3_TOL = 1e-9
PRE_QVEC_TOL = 2.0 ** -23
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


def bands_phase(renderer, cams):
    """The serving renderer's cut at tau 0 for one orbit camera, rendered
    whole and in BAND_COUNTS pixel bands on repeated ``cuda`` devices
    (``render_banded``), each banded run counted: every output equal to
    the full frame bit for bit, K1 launched once per band; then the
    renderer itself with its frames in bands, equal to its whole frames.
    Returns the launch counts per band count."""
    from h3dgs_tpu_torch.ops.rasterize import rasterize
    from h3dgs_tpu_torch.parallel.band_render import render_banded

    cam = cams[0].to(renderer.device)
    renderer._cut_cache = None
    (xyz, scales, quats, opac, shs), count, _, _ = renderer._cut_for(cam,
                                                                     0.0)
    k = (renderer.sh_degree + 1) ** 2
    flat = (xyz, scales, quats, opac, shs[:, :k], cam, renderer.sh_degree,
            renderer.bg)
    full = rasterize(*flat)
    full_ms = time_ms(lambda: rasterize(*flat), 5)
    out = {}
    for n in BAND_COUNTS:
        bands, counts = counted(render_banded, *flat, [DEVICE] * n)
        assert counts == {"blend_fwd": n, "blend_bwd": 0, "ssim": 0}, counts
        for key in ("render", "invdepth", "final_transmittance", "radii"):
            assert torch.equal(bands[key], full[key]), (n, key)
        ms = time_ms(lambda: render_banded(*flat, [DEVICE] * n), 5)
        log(f"{n} pixel bands on one card (render_banded, tau 0, cut "
            f"{int(count)}, {cam.width}x{cam.height}): every output equal "
            f"to the full frame bit for bit; K1 launches {counts['blend_fwd']}"
            f"; {ms:.3f} ms a frame against {full_ms:.3f} ms whole (CUDA "
            f"events, projection once per band)")
        out[f"bands_{n}"] = counts
    whole, _ = renderer.render(cams[1], 0.0)
    renderer.band_devices = [torch.device(DEVICE)] * BAND_COUNTS[0]
    try:
        split, _ = renderer.render(cams[1], 0.0)
    finally:
        renderer.band_devices = None
    assert np.array_equal(whole, split), "banded renderer frame differs"
    log(f"HierarchyRenderer with {BAND_COUNTS[0]} bands: frame equal to "
        f"its whole frame")
    return out


def web_phase(renderer, look_at_camera):
    """``WebViewer`` over the serving renderer: ``/info``, then N_WEB
    ``/frame`` requests at WIDTH x HEIGHT from distinct poses, counted
    around each request, at the viewer's default quality (85) but the last
    at WEB_OTHER_Q; every reply ``image/jpeg`` and byte-equal to
    ``encode_jpeg(renderer.render(cam), q)`` of the same camera (rendered
    after the request, outside the counts), decoded back by the port's
    decoder (PSNR against the render); milliseconds per frame (render +
    JPEG encode + transfer, client clock) and the one-thread encode of the
    last render at q 85 and 95. Returns the launch counts of the
    requests."""
    import http.client

    from h3dgs_tpu_torch.io.jpeg import decode_jpeg
    from h3dgs_tpu_torch.io.jpeg_encode import encode_jpeg
    from h3dgs_tpu_torch.ops import kernels
    from h3dgs_tpu_torch.viewer.web import WebViewer

    viewer = WebViewer(renderer, port=0, tau=SERVE_TAU).start()
    counts = {k: 0 for k in kernels.LAUNCHES}
    ms, psnr, sizes = [], [], []
    try:
        conn = http.client.HTTPConnection("127.0.0.1", viewer.port,
                                          timeout=120)
        conn.request("GET", "/info")
        info = json.loads(conn.getresponse().read())
        assert info["n_nodes"] == renderer.h.n_nodes, info
        c = info["center"]
        for i in range(N_WEB):
            a = 2 * np.pi * i / N_WEB
            q = WEB_OTHER_Q if i == N_WEB - 1 else None
            eye = (c[0] + 5 * np.sin(a), c[1] - 2.0, c[2] - 5 * np.cos(a))
            url = (f"/frame?ex={eye[0]}&ey={eye[1]}&ez={eye[2]}&tx={c[0]}"
                   f"&ty={c[1]}&tz={c[2]}&fovx=1.2&w={WIDTH}&h={HEIGHT}"
                   f"&tau={SERVE_TAU}" + (f"&q={q}" if q else ""))
            kernels.reset_launches()
            t0 = time.perf_counter()
            conn.request("GET", url)
            resp = conn.getresponse()
            body = resp.read()
            ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            for k, v in kernels.LAUNCHES.items():
                counts[k] += v
            assert resp.status == 200, body[:200]
            assert resp.getheader("Content-Type") == "image/jpeg"
            cam = look_at_camera(eye=eye, target=tuple(c), fovx=1.2,
                                 width=WIDTH, height=HEIGHT)
            want, st = renderer.render(cam, SERVE_TAU)
            assert body == encode_jpeg(want, q or 85), \
                "web frame != encode_jpeg(render())"
            assert int(resp.getheader("X-Cut-Size")) == st["cut_size"]
            assert want.max() > 0
            img = decode_jpeg(body)
            assert img.shape == want.shape
            mse = np.mean((img.astype(np.float64) - want) ** 2)
            psnr.append(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))
            sizes.append(len(body))
        conn.close()
    finally:
        viewer.stop()
    assert counts["blend_fwd"] == N_WEB, counts
    enc = encode_ms(want)
    log(f"web viewer ({card_line()}): /info, then {N_WEB} /frame requests "
        f"at {WIDTH}x{HEIGHT}, image/jpeg at q 85 (the last at "
        f"{WEB_OTHER_Q}), each "
        f"byte-equal to encode_jpeg(renderer.render) and decoded back at "
        f"PSNR {', '.join(f'{x:.2f}' for x in psnr)} dB; "
        f"{', '.join(f'{x:.1f}' for x in ms)} ms a frame (render + JPEG "
        f"encode + transfer, client clock; PNG frames took 171.4-216.0 ms, "
        f"PERF.md); {', '.join(f'{x / 1e6:.3f}' for x in sizes)} "
        f"MB; kernel launches {counts}")
    log(f"  JPEG encode of a {WIDTH}x{HEIGHT} frame on the host in one "
        f"thread ({card_line()}): q 85 {enc[85]:.2f} ms, q 95 "
        f"{enc[95]:.2f} ms (median of {JPEG_DECODE_REPS}, in turns)")
    return {"web": counts}


def encode_ms(img, qualities=(85, 95)) -> dict:
    """quality -> median ms of JPEG_DECODE_REPS one-thread ``encode_jpeg``
    calls, the qualities taken in turns (after one call each), so that
    neither is measured first throughout."""
    from h3dgs_tpu_torch.io.jpeg_encode import encode_jpeg

    ts = {q: [] for q in qualities}
    for q in qualities:
        encode_jpeg(img, q)
    for _ in range(JPEG_DECODE_REPS):
        for q in qualities:
            t0 = time.perf_counter()
            encode_jpeg(img, q)
            ts[q].append(1e3 * (time.perf_counter() - t0))
    return {q: float(np.median(t)) for q, t in ts.items()}


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
    rec["step_it"] = [b[0] for b in evs[1:]]
    return rec


def steady_ms(rec, writes=()):
    """The steady window of a run's step times: the intervals that end at
    iteration 6 or later (the first hold the warm-up), less those that
    also hold an artifact write (a checkpoint or save at an iteration of
    ``writes`` happens after that iteration's step, so it falls in the
    next interval). Returns (window, {iteration: ms} of the intervals
    left out)."""
    window, left = [], {}
    for it, ms in zip(rec["step_it"], rec["step_ms"]):
        if it < 6:
            continue
        if it - 1 in writes:
            left[it] = ms
        else:
            window.append(ms)
    return window, left


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
    three are equal unless a cut was truncated). With several views a
    step, "cuts" holds per step the reported size (the largest of the
    step's views) and the (rows, mask count) pair of each view."""
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
            assert len(selected) == len(splatted)
            views = len(selected) // len(reported)
            assert views * len(reported) == len(selected)
            per_view = [
                (rows - st.n_skybox,
                 int(cut_mask(nodes, boxes, limit, center)[0].sum()))
                for rows, (center, limit) in zip(splatted, selected)]
            rec["cuts"] = [(int(c), per_view[i * views:(i + 1) * views])
                           for i, c in enumerate(reported)]
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
    from h3dgs_tpu_torch.train.step import apply_exposure
    from h3dgs_tpu_torch.utils import losses, schedules

    names = ("project", "bin", "blend_fwd K1", "loss",
             "backward (K2 + projection)", "adam + stats + shrink")
    acc = dict.fromkeys(names + ("total",), 0.0)
    cam = batch.camera
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
        image = image * batch.alpha_mask
        photo = losses.photometric_loss(image, batch.gt_image,
                                        opt_cfg.lambda_dssim)
        depth = torch.mean(torch.abs(invd - batch.invdepth)
                           * batch.depth_mask)
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
                     cam.width, image.detach(), batch.gt_image)
        del new, grads, proj
    return acc, k2_inputs


def flat_step_runner(state, batch):
    """A closure that takes one flat train step on ``batch`` (one view or
    a list of views) from ``state`` (the state is not advanced: every call
    does the same work)."""
    from h3dgs_tpu_torch.config import OptimizationConfig
    from h3dgs_tpu_torch.ops import adam as adam_lib
    from h3dgs_tpu_torch.ops.rasterize import RasterizeConfig
    from h3dgs_tpu_torch.parallel.step import make_dp_train_step

    views = batch if isinstance(batch, list) else [batch]
    step = make_dp_train_step(OptimizationConfig(), RasterizeConfig())
    opt = adam_lib.init(state.trainable_dict())
    exposure = torch.eye(3, 4, device=state.device).repeat(
        max(int(v.image_idx) for v in views) + 1, 1, 1)
    exp_opt = adam_lib.init({"exposure": exposure})
    bg = torch.zeros(3, device=state.device)
    return lambda: step(state, opt, exposure, exp_opt, views, 50, bg, 5.0,
                        5.0, 0)


def profile_steps(run, what: str, tmp: str, n_steps: int = 5):
    """Device time of ``n_steps`` calls of ``run`` (one step each) under
    ``utils/profiling.trace`` (torch.profiler over the CPU and the card):
    the busy share of the wall time and the kernels that take the most
    device time. Prints "not measured" when the profiler records no
    device activity."""
    from h3dgs_tpu_torch.utils.profiling import trace

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    with trace(os.path.join(tmp, "trace")) as prof:
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
    log(f"profile of {n_steps} {what}s: wall "
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
    from h3dgs_tpu_torch.train.step import apply_exposure
    from h3dgs_tpu_torch.utils import losses, schedules

    names = ("select", "interpolate (table + gather + sky)", "project",
             "bin", "blend_fwd K1", "loss", "backward (K2 + autograd)",
             "locks + dense adam")
    acc = dict.fromkeys(names + ("total",), 0.0)
    cam = batch.camera
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
        photo = losses.photometric_loss(image * batch.alpha_mask,
                                        batch.gt_image, opt_cfg.lambda_dssim)
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


def _projection_rows(n: int, seed: int):
    """n seeded rows at SH degree 3 in front of a 1600x900 camera, the
    camera on the card as a training view's is."""
    from h3dgs_tpu_torch.scene.camera import look_at_camera

    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def uni(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=DEVICE)

    rows = [uni((n, 3), -3.0, 3.0), torch.exp(uni((n, 3), -5.0, -2.0)),
            torch.randn((n, 4), generator=gen, device=DEVICE),
            uni((n,), 0.0, 1.0),
            0.3 * torch.randn((n, 16, 3), generator=gen, device=DEVICE)]
    cam = look_at_camera(eye=(0.3, -0.2, -6.0), target=(0, 0, 0), fovx=1.1,
                         width=TRAIN_W, height=TRAIN_H).to(DEVICE)
    return rows, cam


def check_project(launches_fwd: int, launches_bwd: int):
    """K4 against the plain projection at the flat step's shape (forward
    and backward through autograd, K2's gradient rows as the cotangents
    of means2d, conic and rgb) and at serving's (forward): every output
    equal but the conic (within PROJ_CONIC_REL of each element), the
    gradients within PROJ_GRAD_TOL_REL; times against the bytes' bound
    and the plain version's."""
    from h3dgs_tpu_torch.ops import projection as proj

    out = {}
    for n, what in ((PROJ_STEP_ROWS, "step"), (PROJ_SERVE_ROWS, "serve")):
        rows, cam = _projection_rows(n, 1)
        got = proj.project_gaussians(*rows, cam, 3)
        want = proj.project_plain(*rows, cam, 3)
        for name in ("means2d", "rgb", "depth", "radius", "valid"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        conic_rel = float(((got.conic - want.conic).abs()
                           / want.conic.abs().clamp_min(1e-30)).max())
        assert conic_rel <= PROJ_CONIC_REL, conic_rel
        fwd_ms = time_ms(lambda: proj.project_gaussians(*rows, cam, 3), 50)
        plain_ms = time_ms(lambda: proj.project_plain(*rows, cam, 3), 5)
        bound = n * PROJ_FWD_BYTES / PEAK_BYTES * 1e3
        out[what] = {"rows": n, "fwd_ms": fwd_ms, "plain_fwd_ms": plain_ms,
                     "fwd_bound_ms": bound, "conic_rel": conic_rel}
        log(f"project_fwd at {n} rows (SH 3, {what}): kernel {fwd_ms:.4f} "
            f"ms, plain {plain_ms:.3f} ms, bound {bound:.4f} ms (bytes, "
            f"{n * PROJ_FWD_BYTES / 1e9:.3f} GB); outputs equal but the "
            f"conic, within {conic_rel:.2e} of each element")
        if what != "step":
            continue
        gen = torch.Generator(device=DEVICE).manual_seed(2)
        k2_rows = torch.randn((n, 12), generator=gen, device=DEVICE)
        g_depth = torch.randn((n,), generator=gen, device=DEVICE)
        cots = [k2_rows[:, 0:2], k2_rows[:, 4:7], k2_rows[:, 8:11], g_depth]

        def fwd_bwd(fn, leaves):
            o = fn(*leaves, cam, 3)
            torch.autograd.backward([o.means2d, o.conic, o.rgb, o.depth],
                                    cots)

        grads = []
        for fn in (proj.project_gaussians, proj.project_plain):
            leaves = [t.clone().requires_grad_(True) for t in rows]
            fwd_bwd(fn, leaves)
            grads.append([leaves[i].grad for i in (0, 1, 2, 4)])
        worst = 0.0
        for name, g, w in zip(("means3d", "scales", "quats", "shs"),
                              *grads):
            rel, cos, _ = _close_grads(g, w)
            worst = max(worst, rel)
            assert rel <= PROJ_GRAD_TOL_REL and cos >= BWD_MIN_COSINE, \
                (name, rel, cos)
        leaves = [t.clone().requires_grad_(True) for t in rows]
        both_ms = time_ms(lambda: fwd_bwd(proj.project_gaussians, leaves),
                          20)
        plain_both_ms = time_ms(lambda: fwd_bwd(proj.project_plain, leaves),
                                3)
        camt = proj._camera_args(cam, DEVICE)
        bwd_ms = time_ms(lambda: proj._launch_bwd(
            *rows[:3], rows[4], camt, TRAIN_W, TRAIN_H, 3, 1.0, *cots), 50)
        bwd_bound = n * PROJ_BWD_BYTES / PEAK_BYTES * 1e3
        out[what].update(bwd_ms=bwd_ms, bwd_bound_ms=bwd_bound,
                         fwd_bwd_ms=both_ms, plain_fwd_bwd_ms=plain_both_ms,
                         grad_rel=worst)
        log(f"project_bwd at {n} rows (SH 3): kernel {bwd_ms:.4f} ms, bound "
            f"{bwd_bound:.4f} ms (bytes, {n * PROJ_BWD_BYTES / 1e9:.3f} GB); "
            f"forward + backward through autograd {both_ms:.4f} ms, plain "
            f"{plain_both_ms:.3f} ms; gradients within {worst:.2e} of max "
            f"|g| of autograd's")
        del leaves, grads, k2_rows, cots
    step = out["step"]
    return {"name": "project", "route": "cuda",
            "source": "h3dgs_tpu_torch/csrc/project.cu", "replaces": None,
            "launches": launches_fwd, "launches_bwd": launches_bwd,
            "max_abs_err": max(step["conic_rel"], step["grad_rel"]),
            "ms": step["fwd_ms"] + step["bwd_ms"],
            "plain_ms": step["plain_fwd_bwd_ms"],
            "bound_ms": step["fwd_bound_ms"] + step["bwd_bound_ms"],
            "bound_by": "bytes", "library_ms": None, "earlier_ms": None,
            "serve_fwd_ms": out["serve"]["fwd_ms"],
            "serve_plain_fwd_ms": out["serve"]["plain_fwd_ms"],
            "serve_fwd_bound_ms": out["serve"]["fwd_bound_ms"]}


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
    check the runs, hold several views a step on the card against the mean
    of single views (``accumulation_check``), save and load the trained
    state in the ``.pt`` format (``pt_check``), train 4 views a step
    (``dp_train_phase``), then create the hierarchy from the trained point
    cloud and post-train it (``post_phase``). Returns (counts per path,
    K2 inputs with a view's render and target for K3)."""
    from h3dgs_tpu_torch.config import OptimizationConfig
    from h3dgs_tpu_torch.io.meta import read_exposure_json
    from h3dgs_tpu_torch.io.ply import read_gaussian_ply
    from h3dgs_tpu_torch.scene.loader import load_view
    from h3dgs_tpu_torch.scene.views import stage_view, staged_to_device

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
    steady, _ = steady_ms(rec)
    one_view_ms = float(np.median(steady))
    log(f"step time (CUDA events between step ends, iterations 6-"
        f"{TRAIN_ITERS}, densify and reset steps included): median "
        f"{one_view_ms:.3f} ms, min {np.min(steady):.3f}, max "
        f"{np.max(steady):.3f}; {1e3 / one_view_ms:.2f} it/s")
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
    batches = [staged_to_device(stage_view(load_view(info, -1), pin=True),
                                DEVICE)
               for info in scene.info.train_cameras[:DP_VIEWS]]
    batch = batches[0]
    stages, k2_inputs = train_stage_times(state, batch, 0,
                                          OptimizationConfig())
    log("train step stages (ms, CUDA events, mean of 5, one view): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    profile_steps(flat_step_runner(state, batch), "train step", tmp)
    accumulation_check(state, batches)
    profile_steps(flat_step_runner(state, batches), f"{DP_VIEWS}-view "
                  f"train step", tmp)
    pt_check(scene, state)
    del rec, scene, state, batches, batch

    out_f = os.path.join(tmp, "model_fused")
    rec_f, counts_f = counted(run_train_cli, base + [
        "-m", out_f, "--iterations", str(FUSED_ITERS)], fused=True)
    assert all(math.isfinite(x) for x in rec_f["photo"] + rec_f["depth"])
    log(f"train_single fused SSIM ({FUSED_ITERS} iterations): photo loss "
        f"first {rec_f['photo'][0]:.5f}, last {rec_f['photo'][-1]:.5f}, "
        f"median step {np.median(steady_ms(rec_f)[0]):.3f} ms; kernel "
        f"launches {counts_f}")
    assert counts_f["ssim"] >= FUSED_ITERS, counts_f
    del rec_f
    torch.cuda.empty_cache()
    jpeg_counts, medians = jpeg_phase(tmp, src, base)
    torch.cuda.empty_cache()
    views_counts = views_phase(tmp, src, base, medians["PNG"])
    torch.cuda.empty_cache()
    dp_counts = dp_train_phase(tmp, base, one_view_ms)
    torch.cuda.empty_cache()
    post_counts = post_phase(tmp, out, src, sc_dir, look_at_camera)
    torch.cuda.empty_cache()
    eval_counts = eval_phase(tmp, out, src, sc_dir, look_at_camera)
    return ({"train": counts, "fused": counts_f, **jpeg_counts,
             **views_counts, **dp_counts, **post_counts, **eval_counts}, k2_inputs)


def jpeg_exactness() -> None:
    """Every committed JPEG fixture through the port's C++ decoder against
    the manifest: PIL's digest (baseline and progressive), OpenCV's
    through ``load_bgr8`` where its read differs (EXIF orientation), and
    the plain version bit-equal below JPEG_PLAIN_MAX pixels; the one with
    unfinished progressive scans must be refused. Then every decoded
    fixture encoded at each quality of the manifest by the C++ encoder
    (and the plain one below JPEG_PLAIN_MAX) to the SHA-256 of PIL's
    bytes."""
    import hashlib

    from h3dgs_tpu_torch.io import jpeg
    from h3dgs_tpu_torch.io import jpeg_encode
    from h3dgs_tpu_torch.preprocess.imgproc import load_bgr8

    def digest(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    assert jpeg._native_decoder() is not None, "no C++ JPEG decoder here"
    assert jpeg_encode._native_encoder() is not None, \
        "no C++ JPEG encoder here"
    with open(os.path.join(JPEG_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    n_cv2 = n_plain = n_refused = n_prog = n_enc = n_enc_plain = 0
    for name, entry in sorted(manifest.items()):
        path = os.path.join(JPEG_DIR, name)
        if entry["refused"]:
            try:
                jpeg.read_jpeg(path)
            except jpeg.UnsupportedJpeg as e:
                n_refused += 1
                log(f"  {name}: refused ({e})")
                continue
            raise AssertionError(f"{name}: an unfinished progressive JPEG "
                                 "was decoded")
        got = jpeg.read_jpeg(path)
        assert list(got.shape) == entry["shape"], (name, got.shape)
        assert digest(got) == entry["pil_sha256"], f"{name} != PIL's"
        n_prog += entry["progressive"]
        if "cv2_bgr_sha256" in entry:
            assert digest(load_bgr8(path)) == entry["cv2_bgr_sha256"], \
                f"{name}: load_bgr8 != cv2.imread"
            n_cv2 += 1
        small = got.shape[0] * got.shape[1] < JPEG_PLAIN_MAX
        if small:
            with open(path, "rb") as f:
                plain = jpeg.decode_jpeg_plain(f.read(), name)
            assert np.array_equal(plain, got), f"{name}: plain != C++"
            n_plain += 1
        for q, sha in entry["encoded_sha256"].items():
            body = jpeg_encode.encode_jpeg(got, int(q))
            assert hashlib.sha256(body).hexdigest() == sha, \
                f"{name}: encode_jpeg at q {q} != PIL's bytes"
            n_enc += 1
            if small:
                assert jpeg_encode.encode_jpeg_plain(got, int(q)) == body, \
                    f"{name}: encode_jpeg_plain at q {q} != C++"
                n_enc_plain += 1
    log(f"JPEG exactness: {len(manifest) - n_refused} fixtures "
        f"({n_prog} progressive) decoded by the C++ decoder to PIL's "
        f"digests, {n_cv2} to OpenCV's default read through load_bgr8 "
        f"(EXIF orientation), {n_plain} also by the plain version bit for "
        f"bit, {n_refused} with unfinished progressive scans refused; "
        f"{n_enc} encodes by the C++ encoder at PIL's bytes' digests, "
        f"{n_enc_plain} also by the plain version byte for byte")


def linked_chunk(root: str, src: str, image: str, ext: str) -> None:
    """The training chunk ``src`` again under ``root``: its cameras, points,
    depths and depth_params linked, and every view's image a hard link to
    ``image``, named ``<view>.<ext>`` in a rewritten images.bin."""
    import dataclasses

    from h3dgs_tpu_torch.io import colmap as colmap_io

    sparse, src_sparse = (os.path.join(d, "sparse", "0") for d in (root, src))
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "images"))
    for f in ("cameras.bin", "points3D.bin", "depth_params.json"):
        os.link(os.path.join(src_sparse, f), os.path.join(sparse, f))
    os.symlink(os.path.join(src, "depths"), os.path.join(root, "depths"))
    imgs = colmap_io.read_images_binary(os.path.join(src_sparse,
                                                     "images.bin"))
    renamed = {}
    for k, im in imgs.items():
        name = os.path.splitext(im.name)[0] + "." + ext
        os.link(image, os.path.join(root, "images", name))
        renamed[k] = dataclasses.replace(im, name=name)
    colmap_io.write_images_binary(os.path.join(sparse, "images.bin"),
                                  renamed)


def decode_rates(files, infos, tmp: str) -> dict:
    """Host decode rates at 1600x900 of each (kind, path, reader) of
    ``files``: one thread (median ms of JPEG_DECODE_REPS), ``load_view``
    views/s in 8 threads (as the view stream runs it), and the Laplacian
    pass over PRE_RATE_VIEWS hard links (``laplacian_rates``)."""
    import concurrent.futures as cf

    from h3dgs_tpu_torch.scene.loader import load_view

    out = {}
    for i, (kind, path, read) in enumerate(files):
        ms = []
        for _ in range(JPEG_DECODE_REPS):
            t0 = time.perf_counter()
            read(path)
            ms.append(1e3 * (time.perf_counter() - t0))
        views = [infos[kind][j % len(infos[kind])]
                 for j in range(JPEG_LOADER_VIEWS)]
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(max_workers=8) as pool:
            n = sum(1 for _ in pool.map(lambda v: load_view(v, -1), views))
        loader = n / (time.perf_counter() - t0)
        links = os.path.join(tmp, f"lap_{i}")
        os.makedirs(links)
        ext = os.path.splitext(path)[1]
        paths = [os.path.join(links, f"v{j:04d}{ext}")
                 for j in range(PRE_RATE_VIEWS)]
        for p in paths:
            os.link(path, p)
        out[kind] = {"decode_ms": float(np.median(ms)),
                     "loader_views_s": loader,
                     "laplacian": laplacian_rates(paths)}
    return out


def jpeg_phase(tmp: str, src: str, base) -> dict:
    """JPEG datasets on the card's machine: the fixtures' exactness
    (``jpeg_exactness``: decoder and encoder); ``train_single`` for
    JPEG_ITERS iterations on the training chunk with its 24 views read
    from the 1600x900 fixture, from its progressive twin (which decodes to
    the same pixels) and from its PNG twin (the decoded pixels as libpng
    filters them), each counted (losses finite, K1 and K2 once per step);
    the host's decode rates of the three, and the one-thread encode of
    the view at q 85 and 95. Returns the runs' launch counts and median
    step ms."""
    from h3dgs_tpu_torch.io.image import read_png
    from h3dgs_tpu_torch.io.jpeg import jpeg_info, read_jpeg

    t_phase = time.perf_counter()
    jpeg_exactness()
    view = os.path.join(JPEG_DIR, JPEG_VIEW)
    prog = os.path.join(JPEG_DIR, JPEG_PROGRESSIVE_VIEW)
    pixels = read_jpeg(view)
    with open(prog, "rb") as f:
        assert jpeg_info(f.read())["sof"] == "progressive"
    assert np.array_equal(read_jpeg(prog), pixels), \
        "the progressive twin's pixels differ from the view's"
    twin = os.path.join(tmp, "jpeg_twin.png")
    filters = write_png_adaptive(twin, pixels)
    runs = (("JPEG", view, "jpg", read_jpeg),
            ("JPEG progressive", prog, "jpg", read_jpeg),
            ("PNG", twin, "png", read_png))
    counts, medians, infos = {}, {}, {}
    for i, (kind, image, ext, _) in enumerate(runs):
        root = os.path.join(tmp, f"chunk_{i}_{ext}")
        linked_chunk(root, src, image, ext)
        argv = ["-s", root] + base[2:] + [
            "-m", os.path.join(tmp, f"model_{i}_{ext}"), "--iterations",
            str(JPEG_ITERS)]
        rec, counts[f"{kind} views"] = counted(run_train_cli, argv)
        c = counts[f"{kind} views"]
        photo = rec["photo"]
        assert len(photo) == JPEG_ITERS, len(photo)
        assert all(math.isfinite(x) for x in photo + rec["depth"]), photo
        assert c["blend_fwd"] >= JPEG_ITERS and \
            c["blend_bwd"] >= JPEG_ITERS, c
        medians[kind] = float(np.median(steady_ms(rec)[0]))
        infos[kind] = rec["scene"].info.train_cameras
        names = {os.path.basename(v.image_path) for v in infos[kind]}
        assert all(n.endswith("." + ext) for n in names), names
        log(f"train_single on {TRAIN_VIEWS} {kind} views ({JPEG_ITERS} "
            f"iterations): photo loss first {photo[0]:.5f}, last "
            f"{photo[-1]:.5f}, median step {medians[kind]:.3f} ms "
            f"(CUDA events, iterations 6-{JPEG_ITERS}); kernel launches {c}")
        del rec
    log(f"JPEG views against their progressive and PNG twins (PNG rows by "
        f"filter None, Sub, Up, Average, Paeth: {filters.tolist()}), one "
        f"call ({card_line()}): median step {medians['JPEG']:.3f} ms, progressive "
        f"{medians['JPEG progressive']:.3f}, PNG {medians['PNG']:.3f} "
        f"({medians['JPEG'] / medians['PNG']:.3f}x, "
        f"{medians['JPEG progressive'] / medians['PNG']:.3f}x)")
    rates = decode_rates([(k, p, r) for k, p, _, r in runs], infos, tmp)
    for kind, r in rates.items():
        lap = r["laplacian"]
        log(f"  {kind} 1600x900 on the host ({card_line()}): one thread "
            f"{r['decode_ms']:.2f} ms a decode (median of "
            f"{JPEG_DECODE_REPS}); load_view in 8 threads "
            f"{r['loader_views_s']:.1f} views/s ({JPEG_LOADER_VIEWS} "
            f"views); Laplacian pass over {PRE_RATE_VIEWS} hard links: "
            f"decode alone {lap['decode']:.1f} images/s, with the card "
            f"{lap['card']:.1f}, with the CPU {lap['CPU']:.1f}")
    enc = encode_ms(pixels)
    log(f"  JPEG encode of the 1600x900 view on the host in one thread "
        f"({card_line()}): q 85 {enc[85]:.2f} ms, q 95 {enc[95]:.2f} ms "
        f"(median of {JPEG_DECODE_REPS}, in turns)")
    log(f"JPEG phase: {time.perf_counter() - t_phase:.1f} s")
    return counts, medians


def png_exactness() -> None:
    """Every committed PNG fixture (``tests/data/torch_png``: every kind,
    non-interlaced and Adam7, and files PIL and OpenCV wrote) decoded by
    the port under the five contracts of the JAX package's callers
    (``read_image`` as PIL's array and as its RGB conversion, and
    ``imgproc``'s three ``cv2.imread`` loaders) to the manifest's
    digests, through the C++ unfilter and again through the plain one;
    then every committed resize case within its stated tolerance of
    ``cv2.resize(INTER_AREA)``, in C++ and in the plain version."""
    import hashlib

    from h3dgs_tpu_torch.io import image as timage
    from h3dgs_tpu_torch.preprocess import imgproc

    def digest(a):
        head = f"{a.dtype.str}{a.shape}".encode()
        a = np.ascontiguousarray(a, np.uint8 if a.dtype == bool else a.dtype)
        return hashlib.sha256(head + a.tobytes()).hexdigest()

    readers = {"pil_array": timage.read_image,
               "pil_rgb": lambda p: timage.read_image(p, "rgb"),
               "cv2_unchanged": imgproc.load_unchanged,
               "cv2_color": imgproc.load_bgr8,
               "cv2_gray": imgproc.load_gray8}
    with open(os.path.join(PNG_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    assert timage._native_unfilter() is not None, "no C++ PNG unfilter"
    assert imgproc._native_resize() is not None, "no C++ area resize"
    n_png, errs = 0, {}
    for plain in (False, True):
        unfilter, resize = timage._NATIVE, imgproc._NATIVE
        if plain:           # False: the plain versions, as without g++
            timage._NATIVE = imgproc._NATIVE = False
        try:
            for name, entry in sorted(manifest["png"].items()):
                path = os.path.join(PNG_DIR, name)
                for key, read in readers.items():
                    assert digest(read(path)) == entry[key], \
                        f"{name}: {key} differs (plain {plain})"
                    n_png += 1
            for name, entry in sorted(manifest["resize"].items()):
                src = np.load(os.path.join(PNG_DIR, entry["src"]))
                want = np.load(os.path.join(PNG_DIR, entry["want"]))
                got = imgproc.resize_area(torch.from_numpy(src),
                                          *want.shape[:2]).numpy()
                assert got.shape == want.shape, (name, got.shape)
                err = float(np.abs(got - want).max())
                assert err <= entry["atol"], (name, plain, err)
                errs[name] = max(errs.get(name, 0.0), err)
        finally:
            timage._NATIVE, imgproc._NATIVE = unfilter, resize
    log(f"PNG exactness: {len(manifest['png'])} fixtures x "
        f"{len(readers)} contracts at the manifest's digests through the "
        f"C++ and the plain unfilter ({n_png} arrays); "
        f"{len(manifest['resize'])} area resizes against cv2.resize "
        f"(C++ and plain), largest distance {max(errs.values())} "
        f"(tolerance 0)")


def _old_resize(arr, w: int, h: int):
    """The port's area resize before OpenCV's INTER_AREA was followed:
    torch's adaptive average pooling (equal to OpenCV at integer factors
    only); kept here as the baseline of the loader's rate."""
    import torch.nn.functional as F

    if arr.shape[1] == w and arr.shape[0] == h:
        return arr
    t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    chw = t[None, None] if t.dim() == 2 else t.permute(2, 0, 1)[None]
    out = F.interpolate(chw, size=(h, w), mode="area")[0]
    return (out[0] if t.dim() == 2 else out.permute(1, 2, 0)).numpy()


def _enlarged(img, h: int, w: int):
    """[H, W, C] or [H, W] uint8 / uint16 -> the same at (h, w) through
    ``resize_area`` (OpenCV's INTER_AREA), rounded."""
    from h3dgs_tpu_torch.preprocess.imgproc import resize_area

    top = np.iinfo(img.dtype).max
    x = resize_area(torch.from_numpy(img.astype(np.float32)), h, w)
    return np.clip(np.rint(x.numpy()), 0, top).astype(img.dtype)


def write_views_chunk(root: str, src: str) -> dict:
    """The training chunk ``src`` again under ``root``, with views, masks
    and depth maps of the kinds the loader repairs: each view enlarged to
    VIEWS_W x VIEWS_H (``-r -1`` shrinks it by 1.25, a non-integer
    factor); a 1-bit mask (even views) or a 2-bit palette mask with tRNS
    (odd views), a disc cut out of each; the 16-bit inverse depths at half
    size (enlarged at load), view 1's as gray+alpha, view 2's missing.
    Cameras, points and depth params are linked. Returns the names of
    the special views."""
    import concurrent.futures as cf

    from h3dgs_tpu_torch.io.image import encode_png_samples, read_png, \
        write_png

    sparse, src_sparse = (os.path.join(d, "sparse", "0") for d in (root, src))
    os.makedirs(sparse)
    for d in ("images", "masks", "depths"):
        os.makedirs(os.path.join(root, d))
    for f in ("cameras.bin", "images.bin", "points3D.bin",
              "depth_params.json"):
        os.link(os.path.join(src_sparse, f), os.path.join(sparse, f))
    names = sorted(os.listdir(os.path.join(src, "images")))
    yy, xx = np.mgrid[:VIEWS_H, :VIEWS_W]
    ga_view, missing = names[1], names[2]

    def one(i: int) -> None:
        name = names[i]
        img = read_png(os.path.join(src, "images", name))
        write_png(os.path.join(root, "images", name),
                  _enlarged(img, VIEWS_H, VIEWS_W), level=1)
        cy = int(VIEWS_H * (0.2 + 0.6 * i / len(names)))
        cx = int(VIEWS_W * (0.15 + 0.7 * i / len(names)))
        r = VIEWS_H / 8
        r2 = (yy - cy) ** 2 + (xx - cx) ** 2
        if i % 2 == 0:
            body = encode_png_samples((r2 > r * r).astype(np.uint8), 1, 0)
        else:
            idx = np.where(r2 > (1.2 * r) ** 2, 3,
                           np.where(r2 > (0.8 * r) ** 2, 2, 0))
            body = encode_png_samples(
                idx.astype(np.uint8), 2, 3,
                [[0, 0, 0], [90, 90, 90], [170, 40, 40], [255, 255, 255]],
                [0, 128])
        with open(os.path.join(root, "masks", name), "wb") as f:
            f.write(body)
        if name == missing:
            return
        depth = _enlarged(read_png(os.path.join(src, "depths", name)),
                          TRAIN_H // 2, TRAIN_W // 2)
        if name == ga_view:
            depth = np.stack([depth, np.full_like(depth, 65535)], -1)
        write_png(os.path.join(root, "depths", name), depth, level=1)

    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(one, range(len(names))))
    return {"ga": ga_view, "missing": missing}


def big_chunk(root: str, src: str, image: str, ext: str) -> None:
    """``linked_chunk`` on a BIG_W x BIG_H view, with the cameras'
    intrinsics scaled to that size on each axis (a camera that sees the
    stretched view), so that ``-r -1`` trains at 1600 x 1200."""
    import dataclasses

    from h3dgs_tpu_torch.io import colmap as colmap_io

    linked_chunk(root, src, image, ext)
    path = os.path.join(root, "sparse", "0", "cameras.bin")
    cams = colmap_io.read_cameras_binary(path)
    os.remove(path)
    sx, sy = BIG_W / TRAIN_W, BIG_H / TRAIN_H
    colmap_io.write_cameras_binary(path, {
        k: dataclasses.replace(c, width=BIG_W, height=BIG_H,
                               params=c.params * [sx, sy, sx, sy])
        for k, c in cams.items()})


def loader_rates(infos) -> dict:
    """``load_view(info, -1)`` views/s in 8 threads (as the view stream
    runs it) over VIEWS_LOADER calls, with the loader's resize as it is
    ("new") and as it was (``_old_resize``, "old"), in the order old,
    new, new, old; the mean of each pair."""
    import concurrent.futures as cf

    from h3dgs_tpu_torch.scene import loader

    views = [infos[j % len(infos)] for j in range(VIEWS_LOADER)]
    new = loader._resize
    rates = {"old": [], "new": []}
    for which in ("old", "new", "new", "old"):
        loader._resize = _old_resize if which == "old" else new
        try:
            t0 = time.perf_counter()
            with cf.ThreadPoolExecutor(max_workers=8) as pool:
                n = sum(1 for _ in pool.map(
                    lambda v: loader.load_view(v, -1), views))
            rates[which].append(n / (time.perf_counter() - t0))
        finally:
            loader._resize = new
    return {k: float(np.mean(v)) for k, v in rates.items()}


def train_views(root: str, base, name: str, extra=()):
    """``train_single`` for VIEWS_ITERS iterations on the chunk at
    ``root``, counted: losses finite, K1 and K2 at least once per step.
    Returns (median step ms, counts, the scene's train cameras)."""
    argv = ["-s", root] + base[2:] + list(extra) + [
        "-m", root + "_model", "--iterations", str(VIEWS_ITERS)]
    rec, c = counted(run_train_cli, argv)
    photo = rec["photo"]
    assert len(photo) == VIEWS_ITERS, len(photo)
    assert all(math.isfinite(x) for x in photo + rec["depth"]), photo
    assert c["blend_fwd"] >= VIEWS_ITERS and \
        c["blend_bwd"] >= VIEWS_ITERS, c
    median = float(np.median(steady_ms(rec)[0]))
    log(f"train_single on {TRAIN_VIEWS} {name} ({VIEWS_ITERS} iterations): "
        f"photo loss first {photo[0]:.5f}, last {photo[-1]:.5f}, median "
        f"step {median:.3f} ms (CUDA events, iterations 6-{VIEWS_ITERS}); "
        f"kernel launches {c}")
    return median, c, rec["scene"].info.train_cameras


def views_phase(tmp: str, src: str, base, png_median: float) -> dict:
    """The views' pixels as the JAX package sees them, on the card's
    machine (no PIL, no OpenCV): ``png_exactness``; then ``train_single``
    counted on the chunk with enlarged views, 1-bit and palette masks and
    half-size depths (one gray+alpha, one missing:
    ``write_views_chunk``), every repaired branch of the loader checked on
    its views; ``load_view`` views/s in 8 threads on BIG_W x BIG_H views
    (PNG and JPEG) with the new and the old resize; and ``train_single``
    counted on BIG_W x BIG_H PNG views, its median step beside the
    1600x900 PNG views' (``png_median``). Returns the runs' counts."""
    import dataclasses

    from h3dgs_tpu_torch.io.image import read_png, write_png
    from h3dgs_tpu_torch.io.jpeg_encode import write_jpeg
    from h3dgs_tpu_torch.scene.loader import _resolution, load_view

    t_phase = time.perf_counter()
    png_exactness()
    t0 = time.perf_counter()
    root = os.path.join(tmp, "chunk_views")
    special = write_views_chunk(root, src)
    log(f"views chunk written in {time.perf_counter() - t0:.1f} s: "
        f"{TRAIN_VIEWS} views {VIEWS_W}x{VIEWS_H}, 1-bit and 2-bit palette "
        f"masks, depths {TRAIN_W // 2}x{TRAIN_H // 2} ({special['ga']} "
        f"gray+alpha, {special['missing']} missing)")
    counts = {}
    med_views, counts["enlarged views"], infos = train_views(
        root, base, f"{VIEWS_W}x{VIEWS_H} masked views",
        ["--alpha_masks", "masks"])
    by_name = {os.path.basename(v.image_path): v for v in infos}
    w, h = _resolution(VIEWS_W, VIEWS_H, -1)
    for name, v in by_name.items():
        b = load_view(v, -1)
        assert b.gt_image.shape == (3, h, w), b.gt_image.shape
        assert b.alpha_mask.min() == 0 and b.alpha_mask.max() > 0.999, \
            name
        assert bool(b.depth_reliable) == (name != special["missing"]), name
        assert b.invdepth.any() == (name != special["missing"]), name
    ref = _enlarged(read_png(os.path.join(src, "images", os.path.basename(
        infos[0].image_path))), h, w).astype(np.float32) / 255
    back = load_view(infos[0], -1)
    gap = float(np.abs(back.gt_image - ref.transpose(2, 0, 1)
                       * back.alpha_mask).mean())
    assert gap < 0.02, gap
    log(f"  views loaded back at {w}x{h}: masks 0..1, depth "
        f"on every view but {special['missing']}; mean distance of a "
        f"view enlarged to {VIEWS_W}x{VIEWS_H} and shrunk back from its "
        f"source {gap:.5f}")

    t0 = time.perf_counter()
    pixels = _enlarged(read_png(os.path.join(src, "images",
                                             sorted(by_name)[0])),
                       BIG_H, BIG_W)
    big = {"PNG": os.path.join(tmp, "big.png"),
           "JPEG": os.path.join(tmp, "big.jpg")}
    write_png(big["PNG"], pixels, level=1)
    write_jpeg(big["JPEG"], pixels, 95)
    big_root = os.path.join(tmp, "chunk_big")
    big_chunk(big_root, src, big["PNG"], "png")
    big_w, big_h = _resolution(BIG_W, BIG_H, -1)
    log(f"{BIG_W}x{BIG_H} views written in {time.perf_counter() - t0:.1f} s")
    med_big, counts["big views"], big_infos = train_views(
        big_root, base, f"{BIG_W}x{BIG_H} PNG views")
    for kind, path in big.items():
        r = loader_rates([dataclasses.replace(v, image_path=path)
                          for v in big_infos])
        log(f"  load_view of {BIG_W}x{BIG_H} {kind} views at -r -1 (-> "
            f"{big_w}x{big_h}, with a {TRAIN_W}x"
            f"{TRAIN_H} depth map) in 8 threads on the host "
            f"({card_line()}): {r['new']:.2f} views/s with resize_area, "
            f"{r['old']:.2f} with the old area pooling ({VIEWS_LOADER} "
            f"views a pass, old/new/new/old)")
    log(f"flat median step, one call ({card_line()}): {TRAIN_W}x{TRAIN_H} "
        f"PNG views {png_median:.3f} ms, {VIEWS_W}x{VIEWS_H} masked views "
        f"{med_views:.3f} ms ({med_views / png_median:.3f}x), "
        f"{BIG_W}x{BIG_H} PNG views (trained at {big_w}x{big_h}) "
        f"{med_big:.3f} ms ({med_big / png_median:.3f}x)")
    log(f"views phase: {time.perf_counter() - t_phase:.1f} s")
    return counts


def dp_train_phase(tmp: str, base, one_view_ms: float):
    """``train_single --views_per_step 4`` on the chunk: DP_ITERS
    iterations (DP_VIEWS * DP_ITERS views), counted; loss falling, locked
    rows bit-equal, K1 and K2 once per view; views/s against the one-view
    run's. Then DP_FUSED_ITERS iterations with the fused loss (K3 once per
    view). Returns the launch counts of both runs."""
    out = os.path.join(tmp, "model_dp")
    t0 = time.perf_counter()
    rec, counts = counted(run_train_cli, base + [
        "-m", out, "--iterations", str(DP_ITERS), "--views_per_step",
        str(DP_VIEWS)])
    wall = time.perf_counter() - t0
    photo = rec["photo"]
    n_views = DP_ITERS * DP_VIEWS
    assert len(photo) == DP_ITERS, len(photo)
    assert all(math.isfinite(x) for x in photo + rec["depth"]), photo
    first, last = np.mean(photo[:10]), np.mean(photo[-10:])
    log(f"train_single --views_per_step {DP_VIEWS} ({DP_ITERS} iterations, "
        f"{n_views} views, {wall:.1f} s wall incl. scene load): photo loss "
        f"(mean of the step's views) first 10 mean {first:.5f}, last 10 "
        f"mean {last:.5f}; kernel launches {counts}")
    assert last < first, (first, last)
    assert counts["blend_fwd"] >= n_views and \
        counts["blend_bwd"] >= n_views, counts
    for k in rec["locked0"]:
        assert torch.equal(rec["locked0"][k], rec["locked1"][k]), k
    steady, _ = steady_ms(rec)
    med = float(np.median(steady))
    log(f"{DP_VIEWS}-view step time (CUDA events between step ends, "
        f"iterations 6-{DP_ITERS}, densify step included): median "
        f"{med:.3f} ms, min {np.min(steady):.3f}, max {np.max(steady):.3f}"
        f"; {DP_VIEWS * 1e3 / med:.2f} views/s against "
        f"{1e3 / one_view_ms:.2f} views/s one view a step "
        f"({DP_VIEWS * one_view_ms / med:.3f}x); locked skybox rows "
        f"({rec['n_locked']}) bit-equal; final alive "
        f"{int(rec['state'].n_alive)} of {rec['state'].capacity}")
    del rec
    torch.cuda.empty_cache()

    rec_f, counts_f = counted(run_train_cli, base + [
        "-m", os.path.join(tmp, "model_dp_fused"), "--iterations",
        str(DP_FUSED_ITERS), "--views_per_step", str(DP_VIEWS)], fused=True)
    assert all(math.isfinite(x) for x in rec_f["photo"] + rec_f["depth"])
    n_fused = DP_FUSED_ITERS * DP_VIEWS
    log(f"train_single --views_per_step {DP_VIEWS} fused SSIM "
        f"({DP_FUSED_ITERS} iterations, {n_fused} views): photo loss first "
        f"{rec_f['photo'][0]:.5f}, last {rec_f['photo'][-1]:.5f}, median "
        f"step {np.median(steady_ms(rec_f)[0]):.3f} ms; kernel launches "
        f"{counts_f}")
    assert counts_f["ssim"] >= n_fused and \
        counts_f["blend_bwd"] >= n_fused, counts_f
    del rec_f
    return {"train_dp": counts, "train_dp_fused": counts_f}


def accumulation_check(state, batches):
    """One DP_VIEWS-view ``make_dp_train_step`` on the card against the
    mean of the views' single-view gradients (``make_view_grads``, the
    same kernels), in float32: the gradients the dp step hands to its
    update, every parameter group and the screen-space offset, within
    ACCUM_TOL of the group's largest value, and the exposure's."""
    from h3dgs_tpu_torch.config import OptimizationConfig
    from h3dgs_tpu_torch.ops import adam as adam_lib
    from h3dgs_tpu_torch.ops.rasterize import RasterizeConfig
    from h3dgs_tpu_torch.parallel import step as dp_lib
    from h3dgs_tpu_torch.train.step import make_view_grads

    opt_cfg = OptimizationConfig()
    n_img = max(int(b.image_idx) for b in batches) + 1
    exposure = torch.eye(3, 4, device=DEVICE).repeat(n_img, 1, 1)
    bg = torch.zeros(3, device=DEVICE)
    seen = {}
    make_update = dp_lib.make_update

    def recording_update(*a, **kw):
        update = make_update(*a, **kw)

        def wrapped(state, opt, exposure, exposure_opt, g_params, g_exp,
                    g_offset, *rest):
            seen.update({k: v.clone() for k, v in g_params.items()},
                        _offset=g_offset.clone(), _exposure=g_exp.clone())
            return update(state, opt, exposure, exposure_opt, g_params,
                          g_exp, g_offset, *rest)
        return wrapped

    dp_lib.make_update = recording_update
    try:
        step = dp_lib.make_dp_train_step(opt_cfg, RasterizeConfig(),
                                         skybox_locked=False)
    finally:
        dp_lib.make_update = make_update
    step(state, adam_lib.init(state.trainable_dict()), exposure,
         adam_lib.init({"exposure": exposure}), batches, 50, bg, 5.0, 5.0, 0)
    view_grads = make_view_grads(opt_cfg, RasterizeConfig())
    want = {}
    for b in batches:
        g = view_grads(state, exposure, b, 50, bg, 0)
        parts = dict(g.g_params, _offset=g.g_offset)
        g_exp = torch.zeros_like(exposure)
        g_exp[b.image_idx] = g.g_exposure
        parts["_exposure"] = g_exp
        for k, v in parts.items():
            want[k] = want.get(k, 0) + v.double() / len(batches)
        del g, parts
    worst = 0.0
    for k, w in want.items():
        # The dp step runs on the rows below the store's high-water mark:
        # the rows above it are dead and take no gradient.
        rows = seen[k].shape[0]
        assert not bool(w[rows:].any()), k
        w = w[:rows]
        scale = float(w.abs().max())
        if scale == 0:
            assert float(seen[k].abs().max()) == 0, k
            continue
        err = float((seen[k].double() - w).abs().max()) / scale
        worst = max(worst, err)
        assert err <= ACCUM_TOL, (k, err)
    log(f"accumulation on the card: {len(batches)}-view dp step's "
        f"gradients against the float64 mean of {len(batches)} single-view "
        f"gradients (same kernels): largest |d| {worst:.3e} of the group's "
        f"largest value (limit {ACCUM_TOL:g}), over "
        f"{', '.join(sorted(want))}")


def pt_check(scene, state):
    """The trained flat state saved in the packed ``.pt`` format (Scene.save
    past PLY_MAX_POINTS, lowered to 0 here) and loaded back through
    Scene's ``.pt`` branch: every array equal."""
    from h3dgs_tpu_torch.config import ModelConfig
    from h3dgs_tpu_torch.scene import scene as scene_lib

    limit = scene_lib.PLY_MAX_POINTS
    scene_lib.PLY_MAX_POINTS = 0
    t0 = time.perf_counter()
    try:
        pc_dir = scene.save(10 ** 6, state)
    finally:
        scene_lib.PLY_MAX_POINTS = limit
    t_save = time.perf_counter() - t0
    files = sorted(os.listdir(pc_dir))
    assert "point_cloud.bin" in files and "done_xyz.pt" in files, files
    size = sum(os.path.getsize(os.path.join(pc_dir, f)) for f in files)
    t0 = time.perf_counter()
    loaded = scene_lib.Scene(
        ModelConfig(source_path=scene.cfg.source_path,
                    model_path=scene.model_path, pretrained=pc_dir),
        scene.runtime, load_iteration=None, device=DEVICE).state
    t_load = time.perf_counter() - t0
    keep = state.alive.clone()
    keep[:state.n_scaffold] = True
    n = int(keep.sum())
    for k in ("xyz", "features_dc", "opacity", "scaling", "rotation"):
        assert torch.equal(getattr(loaded, k)[:n], getattr(state, k)[keep]), k
    assert torch.equal(loaded.features_rest[:n],
                       state.features_rest[keep])
    log(f".pt format: {n} rows of the trained state saved by Scene.save "
        f"(done_*.pt + point_cloud.bin, {size / 1e6:.1f} MB) in "
        f"{t_save:.1f} s and loaded through Scene's .pt branch in "
        f"{t_load:.1f} s (incl. the COLMAP scene); every array equal")
    del loaded
    import shutil
    shutil.rmtree(pc_dir)


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
    from h3dgs_tpu_torch.scene.views import stage_view, staged_to_device
    from h3dgs_tpu_torch.viewer.service import HierarchyRenderer

    # --- hierarchy creation (host), both backends ---
    ply = os.path.join(flat_out, "point_cloud", f"iteration_{TRAIN_ITERS}",
                       "point_cloud.ply")
    seconds = {}
    for backend, where in (("native", flat_out),
                           ("numpy", os.path.join(tmp, "hier_numpy"))):
        t0 = time.perf_counter()
        hierarchy_creator.main([ply, src, where, sc_dir, "--backend",
                                backend])
        seconds[backend] = time.perf_counter() - t0
    hier = os.path.join(flat_out, "hierarchy.hier")
    h0 = read_hier(hier)
    h0.validate()
    anchors = read_anchors(os.path.join(flat_out, "anchors.bin"))
    assert np.array_equal(anchors, h0.anchors)
    assert 0 < anchors.size < h0.n_nodes, anchors.size
    h_np = read_hier(os.path.join(tmp, "hier_numpy", "hierarchy.hier"))
    h_np.validate()
    same = hierarchies_agree(h0, h_np)
    log(f"hierarchy_creator: {h0.n_nodes} nodes, {h0.n_leaves} leaves, "
        f"{anchors.size} anchors; C++ backend {seconds['native']:.1f} s, "
        f"numpy backend {seconds['numpy']:.1f} s (read, build on the host, "
        f"write); the two trees: {same}")

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
    cuts = check_cuts(rec, h0.n_nodes)
    steady, left = steady_ms(rec, writes=(ckpt_it,))
    one_view_ms = float(np.median(steady))
    log(f"post step time (CUDA events between step ends, iterations 6-"
        f"{POST_ITERS} less the step after the checkpoint): median "
        f"{one_view_ms:.3f} ms, min {np.min(steady):.3f}, max "
        f"{np.max(steady):.3f}; {1e3 / one_view_ms:.2f} it/s")
    for it, ms in left.items():
        log(f"post step {it}, after the checkpoint write of iteration "
            f"{it - 1}: {ms:.3f} ms")
    state = rec["state"]
    n_moved, n_locked = locked_rows_kept(rec)
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
    batch = staged_to_device(stage_view(view, pin=True), DEVICE)
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
                               exp_row, limit, 50, bg, 5.0, 0), "post step",
                  tmp)
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
    check_cuts(rec_f, h0.n_nodes)
    log(f"train_post fused SSIM ({POST_FUSED_ITERS} iterations): photo "
        f"loss first {rec_f['photo'][0]:.5f}, last {rec_f['photo'][-1]:.5f}"
        f", median step {np.median(steady_ms(rec_f)[0]):.3f} ms; kernel "
        f"launches {counts_f}")
    assert counts_f == {"blend_fwd": POST_FUSED_ITERS,
                        "blend_bwd": POST_FUSED_ITERS,
                        "ssim": POST_FUSED_ITERS}, counts_f
    del rec_f
    torch.cuda.empty_cache()
    counts_dp = dp_post_phase(tmp, hier, base, h0.n_nodes, one_view_ms)
    return {"post": counts, "post_resumed": counts_r, "post_fused": counts_f,
            "post_dp": counts_dp}


def check_cuts(rec, n_nodes: int):
    """Every view's cut rendered whole (rows rasterized less the skybox =
    the cut mask's count, recomputed), and each step's reported size the
    largest of its views'. Returns the per-view sizes."""
    sizes = []
    for reported, views in rec["cuts"]:
        assert all(r == m for r, m in views), \
            "a post step rendered a truncated cut"
        assert reported == max(r for r, _ in views), (reported, views)
        sizes += [r for r, _ in views]
    log(f"cut sizes over the run: min {min(sizes)}, max {max(sizes)} of "
        f"{n_nodes} nodes over {len(sizes)} views; every cut rendered whole "
        f"(rows rasterized less the skybox = the cut mask's count, "
        f"recomputed; reported size = the step's largest)")
    return sizes


def locked_rows_kept(rec):
    """Anchors and skybox rows bit-equal to their values before the run.
    Returns (rows that changed, locked rows)."""
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
    return n_moved, n_locked


def dp_post_phase(tmp: str, hier: str, base, n_nodes: int,
                  one_view_ms: float):
    """``train_post --views_per_step 4`` over the hierarchy (a link to it
    and its exposures in a directory of its own, so its ``<hier>_opt``
    leaves the one-view run's alone): DP_POST_ITERS iterations, counted;
    every view's cut whole, anchors and skybox rows bit-equal, K1 and K2
    once per view; views/s against the one-view post run's."""
    from h3dgs_tpu_torch.hierarchy.io import read_hier

    dp_dir = os.path.join(tmp, "post_dp_hier")
    os.makedirs(dp_dir)
    dp_hier = os.path.join(dp_dir, "hierarchy.hier")
    os.symlink(hier, dp_hier)
    os.symlink(os.path.join(os.path.dirname(hier), "exposure.json"),
               os.path.join(dp_dir, "exposure.json"))
    argv = [a if a != hier else dp_hier for a in base]
    t0 = time.perf_counter()
    rec, counts = counted(run_post_cli, argv + [
        "-m", os.path.join(tmp, "post_dp"), "--iterations",
        str(DP_POST_ITERS), "--views_per_step", str(DP_VIEWS)])
    wall = time.perf_counter() - t0
    n_views = DP_POST_ITERS * DP_VIEWS
    photo = rec["photo"]
    assert len(photo) == DP_POST_ITERS and all(math.isfinite(x)
                                               for x in photo), photo
    log(f"train_post --views_per_step {DP_VIEWS} ({DP_POST_ITERS} "
        f"iterations, {n_views} views, {wall:.1f} s wall incl. scene and "
        f"hierarchy load): photo loss first {photo[0]:.5f}, last "
        f"{photo[-1]:.5f}; kernel launches {counts}")
    assert counts == {"blend_fwd": n_views, "blend_bwd": n_views,
                      "ssim": 0}, counts
    sizes = check_cuts(rec, n_nodes)
    assert len(sizes) == n_views, len(sizes)
    locked_rows_kept(rec)
    steady, _ = steady_ms(rec)
    med = float(np.median(steady))
    log(f"{DP_VIEWS}-view post step time (CUDA events between step ends, "
        f"iterations 6-{DP_POST_ITERS}): median {med:.3f} ms, min "
        f"{np.min(steady):.3f}, max {np.max(steady):.3f}; "
        f"{DP_VIEWS * 1e3 / med:.2f} views/s against {1e3 / one_view_ms:.2f}"
        f" views/s one view a step ({DP_VIEWS * one_view_ms / med:.3f}x)")
    h1 = read_hier(dp_hier + "_opt")
    h1.validate()
    assert h1.n_nodes == n_nodes and np.isfinite(h1.shs).all()
    log(f"{os.path.basename(dp_hier)}_opt of the {DP_VIEWS}-view run: "
        f"{h1.n_nodes} nodes read back and validated")
    del rec
    return counts


def hierarchies_agree(a, b) -> str:
    """Two builds of one point cloud by the C++ and numpy backends. Both
    order the leaves by Morton code, which the C++ code quantises in
    double and numpy in float32, so a leaf whose position lies within
    rounding of a cell boundary can take another place (and its
    ancestors other attributes). Held: the same tree structure, the same
    leaves as a multiset (position, opacity, SH), the root within 1e-5 of
    its largest value, and at most 1 % of the rows differing beyond 1e-4
    (a CPU build of 200,000 points of this surface: 626 of 399,999).
    Returns a description."""
    assert np.array_equal(a.nodes, b.nodes), "tree structure differs"
    leaf = a.nodes[:, 2] == 0

    def rows(h):
        return np.concatenate([h.xyz, h.alpha[:, None],
                               h.shs.reshape(h.n_nodes, -1)], axis=1)

    ra, rb = rows(a), rows(b)
    la, lb = ra[leaf], rb[leaf]
    la = la[np.lexsort(la[:, ::-1].T)]
    lb = lb[np.lexsort(lb[:, ::-1].T)]
    assert np.array_equal(la, lb), "the leaves differ as a set"
    root = a.nodes[:, 0] < 0
    d_root = float(np.abs(ra[root] - rb[root]).max())
    assert d_root <= 1e-5 * max(1.0, float(np.abs(rb[root]).max())), d_root
    differ = ~np.all(np.abs(ra - rb) <= 1e-4 * np.maximum(1.0, np.abs(rb)),
                     axis=1)
    assert differ.mean() <= 0.01, differ.mean()
    return (f"structure equal, leaves equal as a set, root within "
            f"{d_root:.2e}, {int(differ.sum())} of {a.n_nodes} rows "
            f"({int(differ[leaf].sum())} leaves) placed or merged "
            f"differently, anchors {a.anchors.size} / {b.anchors.size}")


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
    h = read_hier(hier_opt)

    def inside(xyz, lo, hi):
        return ((xyz[:, 0] >= lo[0]) & (xyz[:, 0] <= hi[0])
                & (xyz[:, 1] >= lo[1]) & (xyz[:, 1] <= hi[1]))

    leaf = h.nodes[:, N_CHILDREN] == 0
    want = sum(int((leaf & inside(h.xyz, lo, hi)).sum())
               for lo, hi in bounds.values())
    merged = {}
    for backend in ("native", "numpy"):
        path = os.path.join(tmp, f"merged_{backend}", "merged.hier")
        t0 = time.perf_counter()
        hierarchy_merger.main([trained, "0", chunks, path, *sorted(bounds),
                               "--backend", backend])
        seconds = time.perf_counter() - t0
        m = read_hier(path)
        m.validate()
        assert m.root == 0 and m.nodes[0, N_CHILDREN] == 2, m.nodes[0]
        assert m.n_leaves == want, (backend, m.n_leaves, want)
        m_leaf = m.nodes[:, N_CHILDREN] == 0
        union = np.zeros(m.n_nodes, bool)
        for lo, hi in bounds.values():
            union |= inside(m.xyz, lo, hi)
        assert union[m_leaf].all(), "a merged leaf lies outside both boxes"
        log(f"hierarchy_merger --backend {backend}: 2 chunks of {h.n_nodes} "
            f"nodes ({h.n_leaves} leaves each) -> {m.n_nodes} nodes, "
            f"{m.n_leaves} leaves (= the leaves inside the two half boxes, "
            f"counted with numpy), {m.anchors.size} anchors, validated, in "
            f"{seconds:.1f} s on the host (read, prune, merge, write)")
        merged[backend] = (path, m)
    a, b = merged["native"][1], merged["numpy"][1]
    same = a.n_nodes == b.n_nodes and np.array_equal(a.nodes, b.nodes)
    detail = ""
    if same:
        d = max(float(np.abs(getattr(a, k) - getattr(b, k)).max())
                for k in ("xyz", "alpha", "shs", "boxes"))
        detail = f", largest attribute |d| {d:.2e}"
    log(f"merged trees of the two backends: structure "
        f"{'equal' if same else 'different'}{detail}")
    return merged["native"][0]


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


def pre_cameras(rng):
    """PRE_CAMS views: centers [N, 3] and world-to-camera rotations
    [N, 3, 3] (rows: right, down, forward), forward pitched 35-65 degrees
    below the horizon at a uniform heading."""
    g = int(np.ceil(np.sqrt(PRE_CAMS)))
    cells = rng.permutation(g * g)[:PRE_CAMS]
    step = PRE_AREA / g
    centers = np.stack([
        (cells % g + 0.5 + rng.uniform(-0.3, 0.3, PRE_CAMS)) * step,
        (cells // g + 0.5 + rng.uniform(-0.3, 0.3, PRE_CAMS)) * step,
        rng.uniform(25.0, 40.0, PRE_CAMS)], axis=1)
    heading = rng.uniform(0, 2 * np.pi, PRE_CAMS)
    pitch = np.radians(rng.uniform(35.0, 65.0, PRE_CAMS))
    fwd = np.stack([np.cos(pitch) * np.cos(heading),
                    np.cos(pitch) * np.sin(heading), -np.sin(pitch)], 1)
    right = np.stack([fwd[:, 1], -fwd[:, 0], np.zeros(PRE_CAMS)], 1)
    right /= np.linalg.norm(right, axis=1, keepdims=True)
    down = np.cross(fwd, right)
    return centers, np.stack([right, down, fwd], axis=1)


def pre_visibility(xyz, centers, rots, rng):
    """Per view: the ids (1-based) and float64 pixel positions of up to
    PRE_MAX_VISIBLE points in front of it and inside its frame (projected
    on the card), then a few -1 ids."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(int(rng.integers(1 << 31)))
    pts = torch.as_tensor(xyz, dtype=torch.float64, device=DEVICE)
    out = []
    for c, r in zip(centers, rots):
        rt = torch.as_tensor(r, dtype=torch.float64, device=DEVICE)
        pc = (pts - torch.as_tensor(c, device=DEVICE)) @ rt.T
        z = pc[:, 2]
        u = PRE_FOCAL * pc[:, 0] / z + PRE_W / 2
        v = PRE_FOCAL * pc[:, 1] / z + PRE_H / 2
        idx = torch.nonzero((z > 0.5) & (u >= 0) & (u < PRE_W) & (v >= 0)
                            & (v < PRE_H))[:, 0]
        if idx.numel() > PRE_MAX_VISIBLE:
            pick = torch.randperm(idx.numel(), generator=gen,
                                  device=DEVICE)[:PRE_MAX_VISIBLE]
            idx = idx[pick.sort().values]
        n_bad = int(rng.integers(5, 30))
        xys = np.concatenate([torch.stack([u[idx], v[idx]], 1).cpu().numpy(),
                              rng.uniform(0, PRE_W, (n_bad, 2))])
        pids = np.concatenate([idx.cpu().numpy() + 1,
                               np.full(n_bad, -1, np.int64)])
        out.append((pids, xys))
    return out


def write_png_adaptive(path: str, img) -> None:
    """Write ``img`` ([H, W] or [H, W, C] uint8 / uint16 numpy) as a PNG
    the way libpng does by default (PIL, and COLMAP's undistorter through
    FreeImage): each row with the one of the five filters whose bytes,
    read as signed, sum to the least magnitude, at zlib level 6. The
    filters run on DEVICE. Returns the rows of each filter type."""
    import zlib

    depth = 16 if img.dtype == np.uint16 else 8
    x = torch.from_numpy(img.astype(np.int32)).to(DEVICE)
    if x.ndim == 2:
        x = x[..., None]
    h, w, chans = x.shape
    if depth == 16:         # big-endian sample bytes
        x = torch.stack([x >> 8, x & 255], -1)
    x = x.reshape(h, -1)
    bpp = chans * depth // 8
    left = torch.nn.functional.pad(x, (bpp, 0))[:, :-bpp]
    up = torch.nn.functional.pad(x, (0, 0, 1, 0))[:-1]
    ul = torch.nn.functional.pad(left, (0, 0, 1, 0))[:-1]
    p = left + up - ul
    pa, pb, pc = (p - left).abs(), (p - up).abs(), (p - ul).abs()
    paeth = torch.where((pa <= pb) & (pa <= pc), left,
                        torch.where(pb <= pc, up, ul))
    cand = torch.stack([x, x - left, x - up, x - ((left + up) >> 1),
                        x - paeth]) & 255
    ftype = torch.minimum(cand, 256 - cand).sum(-1).argmin(0)
    rows = cand.gather(0, ftype[None, :, None].expand(1, h, x.shape[1]))[0]
    data = torch.cat([ftype[:, None], rows], 1).to(torch.uint8).cpu()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (len(body).to_bytes(4, "big") + kind + body
                + zlib.crc32(kind + body).to_bytes(4, "big"))
    ihdr = (w.to_bytes(4, "big") + h.to_bytes(4, "big")
            + bytes([depth, {1: 0, 2: 4, 3: 2, 4: 6}[chans], 0, 0, 0]))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(data.numpy().tobytes(), 6))
                + chunk(b"IEND", b""))
    return torch.bincount(ftype, minlength=5).cpu().numpy()


def write_preprocess_project(proj: str, rng) -> dict:
    """The aligned project in the layout the drivers read
    (``camera_calibration/{aligned,rectified/images,rectified/depths}``,
    ``inputs/masks``), and two copies of the masked views' images for the
    black-mask step, and JPEG copies (q 90, ``encode_jpeg``) of the first
    PRE_JPEG_MASKED of them under ``black_jpeg``. Every PNG is written as
    libpng writes it (``write_png_adaptive``), and each texture is decoded
    back to its samples. Returns what the checks need: the blurred and the
    masked views' names, each calibrated view's (a, b), and the textures'
    paths."""
    import shutil

    from h3dgs_tpu_torch.io import colmap as colmap_io
    from h3dgs_tpu_torch.io.image import read_png
    from h3dgs_tpu_torch.io.jpeg_encode import write_jpeg

    cc = os.path.join(proj, "camera_calibration")
    sparse = os.path.join(cc, "aligned", "sparse", "0")
    images = os.path.join(cc, "rectified", "images")
    depths = os.path.join(cc, "rectified", "depths")
    for d in (images, depths, os.path.join(proj, "textures")):
        os.makedirs(d)
    centers, rots = pre_cameras(rng)
    xyz = np.concatenate([rng.uniform(-60.0, PRE_AREA + 60.0,
                                      (PRE_POINTS, 2)),
                          np.zeros((PRE_POINTS, 1))], axis=1)
    error = rng.uniform(0.2, 2.0, PRE_POINTS)
    error[rng.random(PRE_POINTS) < 0.04] = 15.0
    vis = pre_visibility(xyz, centers, rots, rng)

    # Textures: noise softened by a 3 x 3 box, or buried under four 15 x 15
    # boxes (blurred), one file each, hard-linked under the views' names.
    textures, filters = [], np.zeros(5, np.int64)
    for t in range(PRE_TEXTURES + PRE_BLURRED):
        x = torch.rand(1, 3, PRE_H, PRE_W, generator=torch.Generator(
            device=DEVICE).manual_seed(t), device=DEVICE)
        k, reps = (3, 1) if t < PRE_TEXTURES else (15, 4)
        for _ in range(reps):
            x = torch.nn.functional.avg_pool2d(x, k, 1, k // 2,
                                               count_include_pad=False)
        path = os.path.join(proj, "textures", f"tex_{t:02d}.png")
        tex = (x[0].permute(1, 2, 0) * 255).to(torch.uint8).cpu().numpy()
        filters += write_png_adaptive(path, tex)
        assert np.array_equal(read_png(path), tex), path
        textures.append(path)
    cam = colmap_io.ColmapCamera(1, "PINHOLE", PRE_W, PRE_H, np.array(
        [PRE_FOCAL, PRE_FOCAL, PRE_W / 2, PRE_H / 2]))
    imgs, blurred, masked, calib = {}, set(), [], {}
    n_tex = len(textures)
    for i, ((pids, xys), c, r) in enumerate(zip(vis, centers, rots)):
        name = f"view_{i:04d}.png"
        imgs[i + 1] = colmap_io.ColmapImage(
            i + 1, colmap_io.rotmat2qvec(r), -r @ c, 1, name, xys, pids)
        os.link(textures[i % n_tex], os.path.join(images, name))
        if i % n_tex >= PRE_TEXTURES:
            blurred.add(name)
        if i % (PRE_CAMS // PRE_DEPTH_VIEWS) == 0:
            # Inverse depth of the ground plane z = 0 along the pixel's
            # ray, affine in the pixel: -(R^T K^-1 [u, v, 1])_z / c_z.
            a, b = rng.uniform(8.0, 12.0), rng.uniform(0.2, 0.3)
            mx, my = np.meshgrid(np.arange(PRE_W // 2), np.arange(PRE_H // 2))
            inv = -(r[0, 2] * (2 * mx - PRE_W / 2) / PRE_FOCAL
                    + r[1, 2] * (2 * my - PRE_H / 2) / PRE_FOCAL
                    + r[2, 2]) / c[2]
            write_png_adaptive(os.path.join(depths, name), np.clip(np.round(
                (a * inv + b) * 65536), 0, 65535).astype(np.uint16))
            calib[name[:-4]] = (a, b)
        if i % (PRE_CAMS // PRE_MASKS) == 0:
            masked.append(name)
    colmap_io.write_model_binary(
        sparse, {1: cam}, imgs, colmap_io.ColmapPoints3D(
            ids=np.arange(1, PRE_POINTS + 1), xyz=xyz,
            rgb=rng.integers(0, 256, (PRE_POINTS, 3)).astype(np.uint8),
            error=error, track_offsets=np.zeros(PRE_POINTS + 1, np.int64),
            track_image_ids=np.zeros(0, np.int32),
            track_point2d_idxs=np.zeros(0, np.int32)))
    with open(os.path.join(cc, "aligned", "test.txt"), "w") as f:
        f.write("".join(f"view_{i:04d}.png\n" for i in rng.choice(
            PRE_CAMS, PRE_TEST, replace=False)))

    # RGBA masks at half resolution: opaque but for a few discs and a band
    # of alpha near the 127 threshold; and the masked views' images twice.
    gy, gx = torch.meshgrid(torch.arange(PRE_H // 2, device=DEVICE),
                            torch.arange(PRE_W // 2, device=DEVICE),
                            indexing="ij")
    for name in masked:
        alpha = torch.full_like(gx, 255)
        for _ in range(3):
            cx, cy = rng.uniform(0, PRE_W // 2), rng.uniform(0, PRE_H // 2)
            rad = rng.uniform(0.025, 0.1) * PRE_W
            alpha[(gx - cx) ** 2 + (gy - cy) ** 2 < rad ** 2] = 0
        band = (gy > 0.22 * PRE_H) & (gy < 0.26 * PRE_H)
        alpha[band] = 100 + (gx[band] * 7 + gy[band] * 3) % 60
        rgba = torch.stack([torch.full_like(gx, 30), torch.full_like(gx, 90),
                            torch.full_like(gx, 160), alpha], -1)
        write_png_adaptive(os.path.join(proj, "inputs", "masks", name),
                           rgba.to(torch.uint8).cpu().numpy())
        for copy in ("black_card", "black_cpu"):
            os.makedirs(os.path.join(proj, copy), exist_ok=True)
            shutil.copyfile(os.path.join(images, name),
                            os.path.join(proj, copy, name))
    for name in masked[:PRE_JPEG_MASKED]:
        write_jpeg(os.path.join(proj, "black_jpeg", name[:-4] + ".jpg"),
                   read_png(os.path.join(images, name)), 90)
    return {"blurred": blurred, "calib": calib, "masked": masked,
            "textures": textures, "filters": filters}


def chunk_grid(centers: np.ndarray):
    """(bbox corner, n_w, n_h) of the chunker's padded grid
    (``preprocess.chunk.make_chunks``) over these camera centers."""
    bbox = np.stack([centers.min(axis=0), centers.max(axis=0)])
    bbox[0, :2] -= 0.2 * PRE_CHUNK
    bbox[1, :2] += 0.2 * PRE_CHUNK
    extent = bbox[1] - bbox[0]
    padd = PRE_CHUNK - extent[:2] % PRE_CHUNK
    bbox[0, :2] -= padd / 2
    bbox[1, :2] += padd / 2
    extent = bbox[1] - bbox[0]
    return bbox[0], round(extent[0] / PRE_CHUNK), round(extent[1] / PRE_CHUNK)


def tree_bytes(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def check_chunks(cc: str, info: dict) -> list:
    """The chunker's output: chunks.txt lists every chunk written, every
    model loads, camera counts in (PRE_MIN_CAMS, PRE_MAX_CAMS] with at
    least one chunk trimmed to the maximum, no image record keeps points,
    no blurred view is kept, every point lies in its chunk's box (open at
    the grid's border) and in no other chunk. Returns the chunk names."""
    from h3dgs_tpu_torch.io import colmap as colmap_io
    from h3dgs_tpu_torch.io.meta import read_chunks_txt
    from h3dgs_tpu_torch.preprocess.reorient import camera_centers

    chunks_dir = os.path.join(cc, "chunks")
    listed = read_chunks_txt(os.path.join(chunks_dir, "chunks.txt"))
    names = sorted(c["name"] for c in listed)
    assert names == sorted(d for d in os.listdir(chunks_dir)
                           if d != "chunks.txt"), names
    _, aligned, _ = colmap_io.read_model(
        os.path.join(cc, "aligned", "sparse", "0"))
    corner, n_w, n_h = chunk_grid(camera_centers(aligned))
    counts, ids = [], []
    for c in listed:
        i, j = map(int, c["name"].split("_"))
        _, imgs, pts = colmap_io.read_model(
            os.path.join(chunks_dir, c["name"], "sparse", "0"))
        counts.append(len(imgs))
        assert PRE_MIN_CAMS < len(imgs) <= PRE_MAX_CAMS, (c["name"],
                                                          len(imgs))
        assert all(im.point3d_ids.size == 0 and im.xys.size == 0
                   for im in imgs.values())
        kept_blurred = info["blurred"] & {im.name for im in imgs.values()}
        assert not kept_blurred, (c["name"], sorted(kept_blurred)[:5])
        lo = corner[:2] + PRE_CHUNK * np.array([i, j])
        hi = lo + PRE_CHUNK
        np.testing.assert_allclose(c["center"][:2], (lo + hi) / 2,
                                   rtol=1e-6, atol=1e-4)   # float32 file
        lo = np.where([i == 0, j == 0], -1e12, lo)
        hi = np.where([i == n_w - 1, j == n_h - 1], 1e12, hi)
        assert pts.ids.size > 0
        assert np.all(pts.xyz[:, :2] > lo) and np.all(pts.xyz[:, :2] < hi)
        ids.append(pts.ids)
    ids = np.concatenate(ids)
    assert np.unique(ids).size == ids.size, "a point is in two chunks"
    assert max(counts) == PRE_MAX_CAMS, counts
    log(f"  {len(listed)} chunks of a {n_w} x {n_h} grid, cameras "
        f"{min(counts)}-{max(counts)} (in ({PRE_MIN_CAMS}, "
        f"{PRE_MAX_CAMS}]), {ids.size} points, each in one box; no image "
        "record keeps points, no blurred view kept")
    return names


def check_depth_params(cc: str, names: list, info: dict) -> dict:
    """depth_params.json of the aligned scene recovers each calibrated
    view's 1/a and -b/a within PRE_DEPTH_TOL relative and has no view
    without a map; every chunk has its file, with the views of its model
    that have maps. Returns {file: params}."""
    out = {}
    path = os.path.join(cc, "aligned", "sparse", "0", "depth_params.json")
    with open(path) as f:
        params = json.load(f)
    assert sorted(params) == sorted(info["calib"]), len(params)
    worst = 0.0
    for stem, (a, b) in info["calib"].items():
        got = params[stem]
        for have, want in ((got["scale"], 1 / a), (got["offset"], -b / a)):
            worst = max(worst, abs(have - want) / abs(want))
    assert worst <= PRE_DEPTH_TOL, worst
    out[path] = params
    for name in names:
        path = os.path.join(cc, "chunks", name, "sparse", "0",
                            "depth_params.json")
        with open(path) as f:
            out[path] = json.load(f)
        assert set(out[path]) <= set(info["calib"])
    log(f"  aligned: {len(params)} views calibrated, 1/a and -b/a within "
        f"{worst:.3e} relative (limit {PRE_DEPTH_TOL}); "
        f"{PRE_CAMS - len(params)} views without a map absent; "
        f"{len(names)} chunk files")
    return out


def max_param_distance(a: dict, b: dict) -> float:
    """Largest relative distance between two {file: depth params}."""
    worst = 0.0
    assert a.keys() == b.keys()
    for path in a:
        assert a[path].keys() == b[path].keys(), path
        for view, p in a[path].items():
            for q in ("scale", "offset"):
                w = b[path][view][q]
                worst = max(worst, abs(p[q] - w) / max(abs(w), 1e-9))
    return worst


def decoded_tree(root: str) -> dict:
    from h3dgs_tpu_torch.io.image import read_png

    return {f: read_png(os.path.join(root, f)) for f in sorted(
        os.listdir(root))}


def sim3_check(chunk: str, tmp: str, rng) -> dict:
    """``transform_colmap`` of a chunk against a copy moved by a known
    sim(3) (its points with tracks of 4 views). Holds the kept points and
    the camera centres as ``transform_colmap`` composed them (tvec through
    the inverse of the rotation it composed, the moved copy's times the
    known one) to PRE_SIM3_TOL, and each written quaternion to
    PRE_QVEC_TOL of ``rotmat2qvec`` of that rotation. Returns those
    distances, and what reading the centres back through the written
    quaternions gives and why (``rotmat2qvec``'s float32 quaternion, its
    square root per component)."""
    import dataclasses

    from h3dgs_tpu_torch.io import colmap as colmap_io
    from h3dgs_tpu_torch.preprocess.transform import transform_colmap

    cams, imgs, pts = colmap_io.read_model(os.path.join(chunk, "sparse",
                                                        "0"))
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    rot = colmap_io.qvec2rotmat(np.r_[np.cos(0.2), np.sin(0.2) * axis])
    s, t = 1.7, np.array([12.0, -40.0, 3.0])

    def center(im):
        return -colmap_io.qvec2rotmat(im.qvec).T @ im.tvec

    # tvec solves -R^T tvec = center for the R that qvec2rotmat reads back
    # (a float32 quaternion is not unit), so the moved centers are the
    # sim(3) of the chunk's to float64 rounding.
    moved = {}
    for k, im in imgs.items():
        qvec = colmap_io.rotmat2qvec(colmap_io.qvec2rotmat(im.qvec) @ rot.T)
        tvec = np.linalg.solve(colmap_io.qvec2rotmat(qvec).T,
                               -(s * (rot @ center(im)) + t))
        moved[k] = dataclasses.replace(im, qvec=qvec, tvec=tvec)
    n = pts.ids.size
    pts_new = dataclasses.replace(
        pts, xyz=s * (pts.xyz @ rot.T) + t,
        track_offsets=4 * np.arange(n + 1, dtype=np.int64),
        track_image_ids=np.ones(4 * n, np.int32),
        track_point2d_idxs=np.arange(4 * n, dtype=np.int32))
    new_dir = os.path.join(tmp, "moved")
    colmap_io.write_model_binary(os.path.join(new_dir, "sparse", "0"), cams,
                                 moved, pts_new)
    out = os.path.join(tmp, "reanchored")
    transform_colmap(chunk, new_dir, out)
    _, back, pts_back = colmap_io.read_model(os.path.join(out, "sparse",
                                                          "0"))
    assert back.keys() == imgs.keys()
    keep = pts.error < 1.5
    assert np.array_equal(pts_back.ids, pts.ids[keep])
    res = {"points": float(np.abs(pts_back.xyz - pts.xyz[keep]).max()),
           "centers": 0.0, "qvec": 0.0, "read_back": 0.0, "rot_err": 0.0,
           "norm_err": 0.0, "implied": 0.0, "min_component": 1.0}
    for k, im in back.items():
        composed = colmap_io.qvec2rotmat(moved[k].qvec) @ rot
        c = -np.linalg.solve(composed, im.tvec)
        res["centers"] = max(res["centers"],
                             float(np.abs(c - center(imgs[k])).max()))
        res["qvec"] = max(res["qvec"], float(np.abs(
            im.qvec - colmap_io.rotmat2qvec(composed)).max()))
        read = float(np.abs(center(im) - center(imgs[k])).max())
        rot_err = float(np.abs(colmap_io.qvec2rotmat(im.qvec)
                               - composed).max())
        res["norm_err"] = max(res["norm_err"],
                              abs(float(im.qvec @ im.qvec) - 1))
        if read > res["read_back"]:
            res.update(read_back=read, rot_err=rot_err,
                       implied=3 * rot_err * float(np.abs(im.tvec).max()),
                       min_component=float(np.abs(im.qvec).min()))
    return res


def laplacian_rates(paths) -> dict:
    """Images/s of the Laplacian pass over ``paths`` in host threads, as
    ``make_chunks`` runs it: decoding alone, then decoding with the gray
    and Laplacian variance on the card, then on the CPU."""
    import concurrent.futures as cf

    from h3dgs_tpu_torch.preprocess.chunk import laplacian_variance
    from h3dgs_tpu_torch.preprocess.imgproc import load_bgr8

    rates = {}
    for what, fn in (("decode", load_bgr8),
                     ("card", lambda p: laplacian_variance(p, DEVICE)),
                     ("CPU", lambda p: laplacian_variance(p, "cpu"))):
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor() as pool:
            n = sum(1 for _ in pool.map(fn, paths))
        rates[what] = n / (time.perf_counter() - t0)
    return rates


def rate_views(images: str, info: dict, tmp: str) -> dict:
    """The first PRE_RATE_VIEWS views two ways: the project's files (as
    libpng filters them) and the same samples as the port's own encoder
    writes them (filter None on every row, zlib level 6), hard-linked
    under the same names. Returns {kind: paths}."""
    from h3dgs_tpu_torch.io.image import read_png, write_png

    none_dir = os.path.join(tmp, "views_filter_none")
    os.makedirs(none_dir)
    plain = []
    for i, tex in enumerate(info["textures"]):
        plain.append(os.path.join(none_dir, f"tex_{i:02d}.png"))
        write_png(plain[-1], read_png(tex))
    names = sorted(n for n in os.listdir(images))[:PRE_RATE_VIEWS]
    for name in names:
        os.link(plain[int(name[5:9]) % len(plain)],
                os.path.join(none_dir, name))
    return {"libpng's filters": [os.path.join(images, n) for n in names],
            "filter None": [os.path.join(none_dir, n) for n in names]}


def preprocess_phase(tmp: str, rng) -> dict:
    """README steps 1-3 on the synthetic aligned project: ``drivers
    chunks --skip_bundle_adjustment`` as a child process on the card,
    ``drivers depth`` (maps present, no tool), both mask tools, each held
    against the CPU path, then the host modules at this size. Returns each
    step's wall time in seconds."""
    import shutil
    import sqlite3

    from h3dgs_tpu_torch.io import colmap as colmap_io
    from h3dgs_tpu_torch.preprocess import (chunk, colmap_db, depth_scale,
                                            drivers, masks, matchers,
                                            reorient, simplify)

    walls = {}
    t_phase = time.perf_counter()
    proj = os.path.join(tmp, "pre")
    cc = os.path.join(proj, "camera_calibration")
    info = write_preprocess_project(proj, rng)
    walls["write project"] = time.perf_counter() - t_phase
    log(f"preprocessing project written in {walls['write project']:.1f} s: "
        f"{PRE_CAMS} views {PRE_W}x{PRE_H}, {PRE_POINTS} points, "
        f"{len(info['blurred'])} blurred views, {len(info['calib'])} depth "
        f"maps, {len(info['masked'])} masks; the textures' rows by filter "
        f"(None, Sub, Up, Average, Paeth): {info['filters'].tolist()}, "
        "each decoded back to its samples")

    # 1. chunking, on the card in a child process, then on the CPU
    cmd = [sys.executable, "-m", "h3dgs_tpu_torch.preprocess.drivers",
           "chunks", "--project_dir", proj, "--skip_bundle_adjustment",
           "--chunk_size", str(PRE_CHUNK), "--min_n_cams", str(PRE_MIN_CAMS),
           "--max_n_cams", str(PRE_MAX_CAMS)]
    t0 = time.perf_counter()
    run_process_tree(cmd, PRE_TIMEOUT_S)
    walls["drivers chunks (card, child process)"] = time.perf_counter() - t0
    with open(os.path.join(cc, "aligned", "blending_dict.json")) as f:
        blending = f.read()
    names = check_chunks(cc, info)
    t0 = time.perf_counter()
    chunk.make_chunks(os.path.join(cc, "aligned"),
                      os.path.join(cc, "rectified", "images"),
                      os.path.join(tmp, "chunks_cpu"), PRE_CHUNK,
                      min_n_cams=PRE_MIN_CAMS, max_n_cams=PRE_MAX_CAMS,
                      device="cpu")
    walls["make_chunks (CPU)"] = time.perf_counter() - t0
    card_tree = tree_bytes(os.path.join(cc, "raw_chunks"))
    assert card_tree == tree_bytes(os.path.join(tmp, "chunks_cpu")), \
        "the CPU chunk tree differs from the card's"
    with open(os.path.join(cc, "aligned", "blending_dict.json")) as f:
        assert f.read() == blending, "blending_dict.json differs"
    log(f"  chunks: card (child, with its start) "
        f"{walls['drivers chunks (card, child process)']:.1f} s, CPU "
        f"{walls['make_chunks (CPU)']:.1f} s; {len(card_tree)} files "
        f"byte-equal, blending_dict.json equal")

    images = os.path.join(cc, "rectified", "images")
    for kind, paths in rate_views(images, info, tmp).items():
        rates = laplacian_rates(paths)
        log(f"  Laplacian pass, {PRE_RATE_VIEWS} views in host threads, "
            f"{kind}: decode alone {rates['decode']:.1f} images/s, with "
            f"the card {rates['card']:.1f}, with the CPU "
            f"{rates['CPU']:.1f}; decoding is "
            f"{rates['card'] / rates['decode']:.1%} of the card pass")

    # 2. depth calibration of the aligned scene and every chunk
    t0 = time.perf_counter()
    drivers.main(["depth", "--project_dir", proj])
    walls["drivers depth (card)"] = time.perf_counter() - t0
    card_params = check_depth_params(cc, names, info)
    t0 = time.perf_counter()
    depths = os.path.join(cc, "rectified", "depths")
    depth_scale.make_depth_scale(os.path.join(cc, "aligned"), depths,
                                 device="cpu")
    depth_scale.make_chunks_depth_scale(os.path.join(cc, "chunks"), depths,
                                        device="cpu")
    walls["depth calibration (CPU)"] = time.perf_counter() - t0
    cpu_params = {p: json.load(open(p)) for p in card_params}
    dist = max_param_distance(card_params, cpu_params)
    assert dist <= PRE_CPU_TOL, dist
    log(f"  depth: card {walls['drivers depth (card)']:.1f} s, CPU "
        f"{walls['depth calibration (CPU)']:.1f} s, largest relative "
        f"distance {dist:.3e} (limit {PRE_CPU_TOL})")

    # 3. masks: uint8 from the RGBA masks, then black on the masked views
    outs = {}
    for where, dev in (("card", []), ("CPU", ["--device", "cpu"])):
        t0 = time.perf_counter()
        out = os.path.join(proj, f"masks_{where}")
        masks.main(["uint8", "--in_dir", os.path.join(proj, "inputs",
                                                      "masks"),
                    "--out_dir", out] + dev)
        masks.main(["black", "--images_dir",
                    os.path.join(proj, f"black_{where.lower()}"),
                    "--masks_dir", out] + dev)
        walls[f"masks uint8 + black ({where})"] = time.perf_counter() - t0
        outs[where] = (decoded_tree(out), decoded_tree(
            os.path.join(proj, f"black_{where.lower()}")))
    for a, b in zip(outs["card"], outs["CPU"]):
        assert a.keys() == b.keys() and len(a) == len(info["masked"])
        assert all(np.array_equal(a[k], b[k]) for k in a)
    black = outs["card"][1]
    zeroed = np.mean([float((v == 0).all(-1).mean()) for v in black.values()])
    assert 0.01 < zeroed < 0.9, zeroed
    log(f"  masks: card {walls['masks uint8 + black (card)']:.1f} s, CPU "
        f"{walls['masks uint8 + black (CPU)']:.1f} s; {len(black)} masks "
        f"and masked views bit-equal; {zeroed:.1%} of pixels blacked")
    n_jpeg = black_jpeg_check(os.path.join(proj, "black_jpeg"),
                              os.path.join(proj, "masks_card"))
    log(f"  masks black on {n_jpeg} JPEG views (card): each written back "
        f"byte-equal to encode_jpeg(masked pixels, 95), what cv2.imwrite "
        f"writes")

    # 4. host modules at this size
    first = os.path.join(cc, "chunks", names[0])
    host = os.path.join(tmp, "host")
    steps = [
        ("auto_reorient", lambda: reorient.auto_reorient(
            os.path.join(cc, "aligned", "sparse", "0"),
            os.path.join(host, "reoriented"))),
        ("simplify_images", lambda: simplify.simplify_images(
            os.path.join(host, "simplify"))),
        ("make_distance_matcher_file", lambda:
            matchers.make_distance_matcher_file(
                os.path.join(first, "sparse", "0"),
                os.path.join(host, "matching.txt"), n_neighbours=200)),
        ("fill_database", lambda: colmap_db.fill_database(
            os.path.join(host, "database.db"),
            os.path.join(first, "sparse", "0"))),
        ("transform_colmap", lambda: sim3_check(first, host, rng)),
    ]
    os.makedirs(os.path.join(host, "simplify"))
    shutil.copyfile(os.path.join(cc, "aligned", "sparse", "0", "images.bin"),
                    os.path.join(host, "simplify", "images.bin"))
    results = {}
    for name, fn in steps:
        t0 = time.perf_counter()
        results[name] = fn()
        walls[name] = time.perf_counter() - t0
    rot, scale = results["auto_reorient"]
    assert abs(np.linalg.det(rot) - 1) < 1e-9 and np.isfinite(scale) and \
        scale > 0, (rot, scale)
    assert results["simplify_images"] == PRE_CAMS, results["simplify_images"]
    _, chunk_imgs, _ = colmap_io.read_model(os.path.join(first, "sparse",
                                                         "0"))
    n_pairs = results["make_distance_matcher_file"]
    assert 0 < n_pairs <= len(chunk_imgs) * 199, n_pairs
    conn = sqlite3.connect(os.path.join(host, "database.db"))
    n_rows = conn.execute("SELECT COUNT(*) FROM images").fetchone()[0]
    conn.close()
    assert n_rows == len(chunk_imgs), n_rows
    sim3 = results["transform_colmap"]
    assert sim3["points"] <= PRE_SIM3_TOL and \
        sim3["centers"] <= PRE_SIM3_TOL and sim3["qvec"] <= PRE_QVEC_TOL, sim3
    log(f"  host modules: auto_reorient {walls['auto_reorient']:.1f} s "
        f"(upscale {scale:.4f}), simplify_images "
        f"{walls['simplify_images']:.1f} s ({PRE_CAMS} kept), "
        f"make_distance_matcher_file(200) on chunk {names[0]} "
        f"{walls['make_distance_matcher_file']:.1f} s ({n_pairs} pairs), "
        f"fill_database {walls['fill_database']:.1f} s ({n_rows} images), "
        f"transform_colmap {walls['transform_colmap']:.1f} s (sim(3) "
        f"recovered: points within {sim3['points']:.3e}, camera centres "
        f"as composed within {sim3['centers']:.3e} (limit {PRE_SIM3_TOL}),"
        f" quaternions within {sim3['qvec']:.3e} of the composed "
        f"rotation's (limit {PRE_QVEC_TOL:.3e}))")
    log(f"  centres read back through the written quaternions: within "
        f"{sim3['read_back']:.3e}; largest |q.q - 1| {sim3['norm_err']:.3e}"
        f"; at the worst camera R(q) differs from the composed rotation "
        f"by {sim3['rot_err']:.3e} (smallest |q component| "
        f"{sim3['min_component']:.3e}), 3 x that x |tvec| = "
        f"{sim3['implied']:.3e}")
    walls["phase total"] = time.perf_counter() - t_phase
    log("preprocessing phase: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in walls.items()))
    return walls


def black_jpeg_check(images: str, masks_dir: str) -> int:
    """``masks black`` on the card over JPEG views: each file must come
    back as ``encode_jpeg`` at quality 95 of its decoded pixels zeroed
    where the mask (resized nearest to the view) is below 128. Returns the
    number of views."""
    from h3dgs_tpu_torch.io.jpeg import read_jpeg
    from h3dgs_tpu_torch.io.jpeg_encode import encode_jpeg
    from h3dgs_tpu_torch.preprocess import masks
    from h3dgs_tpu_torch.preprocess.imgproc import load_gray8, resize_nearest

    names = sorted(os.listdir(images))
    want = {}
    for name in names:
        px = read_jpeg(os.path.join(images, name))
        mask = torch.from_numpy(load_gray8(os.path.join(
            masks_dir, name[:-4] + ".png")))
        mask = resize_nearest(mask, *px.shape[:2]).numpy()
        px[mask < 128] = 0
        want[name] = encode_jpeg(px, 95)
    assert masks.black_mask_images(images, masks_dir, DEVICE) == len(names)
    for name in names:
        with open(os.path.join(images, name), "rb") as f:
            assert f.read() == want[name], f"masks black: {name}"
    return len(names)


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
    del inputs, args
    band_counts = bands_phase(renderer, cams)
    web_counts = web_phase(renderer, look_at_camera)
    del renderer
    torch.cuda.empty_cache()

    # --- the training paths, counted ---
    with tempfile.TemporaryDirectory() as tmp:
        train_counts, k2_inputs = training_phase(tmp, rng, look_at_camera)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        orchestrate_phase(tmp, rng, look_at_camera)
    with tempfile.TemporaryDirectory() as tmp:
        _, pre_counts = counted(preprocess_phase, tmp, rng)
    log(f"preprocessing path, in process: kernel launches {pre_counts} "
        "(its image work is plain torch)")
    dp_views = DP_VIEWS * (DP_ITERS + DP_FUSED_ITERS + DP_POST_ITERS)
    jpeg_views = 3 * JPEG_ITERS         # JPEG, progressive and PNG views
    kind_views = 2 * VIEWS_ITERS        # enlarged masked views, 4032x3024
    views = (TRAIN_ITERS + FUSED_ITERS + jpeg_views + kind_views + POST_ITERS
             + POST_RESUMED + POST_FUSED_ITERS + dp_views)
    fused_views = FUSED_ITERS + POST_FUSED_ITERS + DP_VIEWS * DP_FUSED_ITERS
    eval_frames = TRAIN_VIEWS * len(EVAL_TAUS)
    paths = {"serve": launches, **band_counts, **web_counts, **train_counts}
    total = {k: sum(c[k] for c in paths.values()) for k in launches}
    n_bands = sum(BAND_COUNTS)
    log(f"kernel launches over the {len(paths)} paths: {total} ({frames} "
        f"frames, {n_bands} bands, {N_WEB} web frames, {views} training "
        f"views ({dp_views} of them {DP_VIEWS} a step, {fused_views} with "
        f"the fused loss, {jpeg_views} read from baseline and progressive "
        f"JPEG files and PNG twins, {kind_views} from enlarged views with "
        f"1-bit and palette masks and from {BIG_W}x{BIG_H} views), "
        f"{eval_frames} evaluation frames, 1 "
        f"render call)")
    assert total["blend_fwd"] >= (frames + n_bands + N_WEB + views
                                  + eval_frames + 1), total
    assert total["blend_bwd"] >= views, total
    assert total["ssim"] >= fused_views, total
    assert total["project_fwd"] >= total["blend_fwd"], total
    assert total["project_bwd"] >= total["blend_bwd"], total
    for name, n in total.items():
        assert n > 0, f"kernel {name} was not launched on the main paths"

    # --- kernels against their plain versions (not counted) ---
    k1_row["launches"] = total["blend_fwd"]
    rows = [k1_row, check_blend_bwd(k2_inputs, total["blend_bwd"]),
            check_ssim(k2_inputs[8], k2_inputs[9], total["ssim"]),
            check_project(total["project_fwd"], total["project_bwd"])]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"peak device memory allocated: {peak_gb:.2f} GB")

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
