#!/usr/bin/env python3
"""Floor experiments on the port's fused SSIM kernel (K3), on one NVIDIA GPU.

Builds ``h3dgs_tpu_torch/csrc/ssim.cu`` and variants of it made by text
substitution (other strip widths and occupancy targets, the second blur or
the shared-memory loads removed, IEEE division in place of the reciprocal),
times each at 1600x900 and 1920x1080 with CUDA events over back-to-back
launches, and holds every variant that still computes the function
against the plain PyTorch version in float32 and in float64. Inputs: a
smooth seeded image pair (low-passed noise, the prediction the target plus
noise) and a dark, low-variance pair (the SSIM variance terms cancel).

With ``--old-dir DIR`` it also builds the three-launch kernel of the first
port from ``DIR/ssim.cu`` (e.g. ``git show <commit>:h3dgs_tpu_torch/csrc/
ssim.cu > DIR/ssim.cu``) with ``-fmad=false`` as it was built, and times it
whole, without its gradient launch, without its loss launch and without
the per-call copy of the window: what each part of the old design cost.

Run: python3 scripts/torch_ssim_experiments.py [--old-dir DIR] [name ...]
(from the repository root; names select variants by substring). Variants
with a part removed give wrong outputs: their times say what the part
costs, nothing else.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from h3dgs_tpu_torch.ops import kernels, ssim  # noqa: E402

BUILD = os.path.join(kernels.BUILD_DIR, "experiments")
V, I, D, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
              ctypes.c_float)
SIZES = ((900, 1600), (1080, 1920))
SMALL = ((11, 11), (37, 53), (129, 217))


def log(*parts) -> None:
    print(" ".join(str(p) for p in parts), flush=True)


def sub(src: str, *pairs) -> str:
    for old, new in pairs:
        assert old in src, f"pattern not in source: {old!r}"
        src = src.replace(old, new)
    return src


def build(name: str, src: str, flags=()):
    """nvcc the source text into BUILD/lib<name>.so; returns (lib, ptxas
    lines)."""
    os.makedirs(BUILD, exist_ok=True)
    cu = os.path.join(BUILD, f"{name}.cu")
    so = os.path.join(BUILD, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, *flags,
                           "-o", so, cu], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: build failed\n{proc.stdout}"
                           f"{proc.stderr}")
    lines = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    return ctypes.CDLL(so), lines


FMA_PEAK_SRC = r"""
#include <cuda_runtime.h>
// 8 independent chains of fused multiply-adds per thread, nothing else.
__global__ void __launch_bounds__(128) fma_stream(float* out, int iters) {
  float a[8];
  for (int k = 0; k < 8; ++k) a[k] = threadIdx.x * 1e-3f + k;
  const float m = 1.0000001f, c = 1e-7f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
#pragma unroll
      for (int k = 0; k < 8; ++k) a[k] = __fmaf_rn(a[k], m, c);
    }
  }
  float s = 0.0f;
  for (int k = 0; k < 8; ++k) s += a[k];
  if (s == 123.456f) out[0] = s;
}
extern "C" int fma_stream_launch(float* out, int blocks, int iters,
                                 void* stream) {
  fma_stream<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(out,
                                                                    iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def fma_peak():
    """The FP32 multiply-add rate this card delivers to this script's
    timing loop (12 warps per SM of pure FFMA, bursts as short as the
    kernel's), beside the data sheet's 67 TFLOP/s."""
    lib, _ = build("fma_stream", FMA_PEAK_SRC)
    lib.fma_stream_launch.restype = I
    lib.fma_stream_launch.argtypes = [V, I, I, V]
    out = torch.zeros((1,), device="cuda")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 3 * n_sm, 512

    def run():
        kernels.check("fma_stream", lib.fma_stream_launch(
            out.data_ptr(), blocks, iters,
            torch.cuda.current_stream().cuda_stream))

    ms = time_ms(run)
    flops = 2.0 * blocks * 128 * iters * 16 * 8
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"pure FFMA stream: {ms:.4f} ms per launch, "
        f"{flops / ms / 1e9:.1f} TFLOP/s (data sheet 67); SM clock now / "
        f"max: {clocks}")


def sass_mix(name: str):
    """Opcode counts of the fused kernel's SASS (whole kernel: the walk's
    loop body is nearly all of it), where the toolkit has cuobjdump."""
    tool = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        log("no cuobjdump: instruction mix not measured")
        return
    out = subprocess.run([tool, "-sass",
                          os.path.join(BUILD, f"lib{name}.so")],
                         capture_output=True, text=True).stdout
    counts = {}
    for line in out.splitlines():
        parts = line.split()
        if len(parts) < 2 or not parts[0].startswith("/*"):
            continue
        op = parts[1] if not parts[1].startswith("@") else parts[2]
        op = op.rstrip(";").split(".")[0]
        counts[op] = counts.get(op, 0) + 1
    total = sum(counts.values())
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:16]
    log(f"{name} SASS: {total} instructions; "
        + ", ".join(f"{k} {v}" for k, v in top))
    with open(os.path.join(BUILD, f"{name}.sass"), "w") as f:
        f.write(out)


def images(h: int, w: int, dark: bool, seed: int = 0):
    g = torch.Generator(device="cuda").manual_seed(seed + h * w)
    if dark:
        x = 0.02 + 0.002 * torch.rand((3, h, w), generator=g, device="cuda")
        y = 0.02 + 0.002 * torch.rand((3, h, w), generator=g, device="cuda")
        return x.contiguous(), y.contiguous()
    noise = torch.rand((1, 3, h, w), generator=g, device="cuda")
    k = min(9, 2 * (min(h, w) // 4) + 1)
    y = torch.nn.functional.avg_pool2d(noise, k, 1, k // 2)[0]
    y = ((y - y.min()) / (y.max() - y.min())).contiguous()
    x = (y + 0.05 * torch.randn((3, h, w), generator=g, device="cuda"))
    return x.clamp(0, 1).contiguous(), y


class New:
    """The one-launch kernel's C interface (``ssim_launch`` of the
    committed source and of its variants)."""

    def __init__(self, lib, slots=None):
        self.lib = lib
        lib.ssim_launch.restype = I
        lib.ssim_launch.argtypes = [V, V, I, I, I, D] + [V] * 6
        lib.ssim_tile_width.restype = I
        lib.ssim_occupancy.restype = I
        lib.ssim_occupancy.argtypes = [ctypes.POINTER(I)] * 2
        blocks, threads = I(0), I(0)
        kernels.check("ssim", lib.ssim_occupancy(ctypes.byref(blocks),
                                                 ctypes.byref(threads)))
        self.per_sm, self.threads = blocks.value, threads.value
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        self.slots = slots or self.per_sm * n_sm
        self.ticket = torch.empty((1,), dtype=torch.int32, device="cuda")
        self.window = (F * ssim.WIN)(*ssim._window())

    def plan(self, h, w):
        return ssim.plan_strips(h, w, self.lib.ssim_tile_width(),
                                self.slots)

    def __call__(self, x, y, lam=0.2):
        _, h, w = x.shape
        strips, rows, down = self.plan(h, w)
        partial = torch.empty((6 * strips * down,), dtype=torch.float64,
                              device="cuda")
        grad = torch.empty_like(x)
        loss = torch.empty((1,), dtype=torch.float32, device="cuda")
        status = self.lib.ssim_launch(
            x.data_ptr(), y.data_ptr(), h, w, rows, lam,
            ctypes.addressof(self.window), partial.data_ptr(),
            self.ticket.data_ptr(), grad.data_ptr(), loss.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        kernels.check("ssim", status)
        return loss[0], grad


class Old:
    """The three-launch kernel's C interface (the first port)."""

    def __init__(self, lib):
        self.lib = lib
        lib.ssim_launch.restype = I
        lib.ssim_launch.argtypes = [V, V, I, I, F] + [V] * 8
        lib.ssim_num_blocks.restype = I
        lib.ssim_num_blocks.argtypes = [I, I]
        self.window = (F * ssim.WIN)(*ssim._window())

    def __call__(self, x, y, lam=0.2):
        _, h, w = x.shape
        coef = torch.empty((3, 3, h, w), dtype=torch.float32, device="cuda")
        partial = torch.empty((2 * self.lib.ssim_num_blocks(h, w),),
                              dtype=torch.float32, device="cuda")
        grad = torch.empty_like(x)
        loss = torch.empty((1,), dtype=torch.float32, device="cuda")
        status = self.lib.ssim_launch(
            x.data_ptr(), y.data_ptr(), h, w, lam,
            ctypes.addressof(self.window), coef[0].data_ptr(),
            coef[1].data_ptr(), coef[2].data_ptr(), partial.data_ptr(),
            grad.data_ptr(), loss.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        kernels.check("ssim", status)
        return loss[0], grad


def time_ms(fn, reps: int = 50) -> float:
    for _ in range(3):
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


def errors(fn, x, y):
    """Loss and gradient distance of ``fn`` and of the float32 plain
    version from the float64 plain version, and of ``fn`` from the
    float32 plain version."""
    loss, grad = fn(x, y)
    torch.cuda.synchronize()
    p_loss, p_grad = ssim.fused_photometric_plain(x, y, 0.2)
    r_loss, r_grad = ssim.fused_photometric_plain(x.double(), y.double(),
                                                  0.2)
    scale = float(r_grad.abs().max())
    return {
        "loss": float(loss),
        "d_loss_vs_plain": abs(float(loss) - float(p_loss)),
        "d_grad_vs_plain": float((grad - p_grad).abs().max()) / scale,
        "loss_err64": abs(float(loss) - float(r_loss)),
        "plain_loss_err64": abs(float(p_loss) - float(r_loss)),
        "grad_err64": float((grad.double() - r_grad).abs().max()) / scale,
        "plain_grad_err64": float((p_grad.double() - r_grad).abs().max())
        / scale,
        "grad_rms64": float((grad.double() - r_grad).pow(2).mean().sqrt())
        / scale,
        "plain_grad_rms64": float((p_grad.double() - r_grad).pow(2).mean()
                                  .sqrt()) / scale,
        "finite": bool(torch.isfinite(grad).all()),
    }


def make_variants(src: str):
    """name -> (source, nvcc flags, wrapper kwargs, computes the function)."""
    return {
        "committed": (src, (), {}, True),
        "fmad_false": (src, ("-fmad=false",), {}, True),
        # Every blur tap a product and a sum, each rounded: the plain
        # version's roundings.
        "separate_roundings": (sub(src, (
            "#include <cuda_runtime.h>\n",
            "#include <cuda_runtime.h>\n#define __fmaf_rn(a, b, c) "
            "__fadd_rn(__fmul_rn((a), (b)), (c))\n")), (), {}, True),
        "threads_256": (sub(src, ("kThreads = 128;", "kThreads = 256;"),
                            ("kMinBlocksPerSM = 3;", "kMinBlocksPerSM = 1;")),
                        (), {}, True),
        "min_blocks_2": (sub(src, ("kMinBlocksPerSM = 3;",
                                   "kMinBlocksPerSM = 2;")), (), {}, True),
        "min_blocks_4": (sub(src, ("kMinBlocksPerSM = 3;",
                                   "kMinBlocksPerSM = 4;")), (), {}, True),
        "two_waves": (src, (), {"slots": 2 * 3 * 132}, True),
        "half_wave": (src, (), {"slots": 3 * 132 // 2}, True),
        "ieee_division": (sub(src, ("__frcp_rn(B1)", "__fdiv_rn(1.0f, B1)"),
                              ("__frcp_rn(B2)", "__fdiv_rn(1.0f, B2)")),
                          (), {}, True),
        # Parts removed (wrong outputs; times only).
        "no_stage2": (sub(src, ("gu = __fmaf_rn(wj, r[2 * kRowLen + j], gu);",
                                "gu = __fmaf_rn(wj, cu, gu);"),
                          ("gp = __fmaf_rn(wj, r[3 * kRowLen + j], gp);", ""),
                          ("gr = __fmaf_rn(wj, r[4 * kRowLen + j], gr);", ""),
                          ("a2[1][slot] = __fmaf_rn(wj, gp, a2[1][slot]);",
                           ""),
                          ("a2[2][slot] = __fmaf_rn(wj, gr, a2[2][slot]);",
                           "")), (), {}, False),
        "no_shared_loads": (sub(src,
                                ("const float a = r[j];",
                                 "const float a = xv + wj;"),
                                ("const float c = r[kRowLen + j];",
                                 "const float c = yv + wj;"),
                                ("r[2 * kRowLen + j]", "(cu + wj)"),
                                ("r[3 * kRowLen + j]", "(cp + wj)"),
                                ("r[4 * kRowLen + j]", "(cr + wj)")),
                            (), {}, False),
        "no_column_rings": (sub(src,
                                ("a1[0][slot] = __fmaf_rn(wj, hu, "
                                 "a1[0][slot]);", ""),
                                ("a1[1][slot] = __fmaf_rn(wj, hv, "
                                 "a1[1][slot]);", ""),
                                ("a1[2][slot] = __fmaf_rn(wj, hp, "
                                 "a1[2][slot]);", ""),
                                ("a1[3][slot] = __fmaf_rn(wj, hq, "
                                 "a1[3][slot]);", ""),
                                ("a1[4][slot] = __fmaf_rn(wj, hr, "
                                 "a1[4][slot]);", "")),
                            (), {}, False),
        "no_coefficients": (sub(src, ("if (s >= kHalo && col_in\n            && static_cast"
                                      "<unsigned>(oy - kHalo - kRad + s)\n"
                                      "                   < static_cast"
                                      "<unsigned>(h)) {",
                                      "cu = u + fp2; cp = v + fq2; cr = fr2;"
                                      "\n    if (s < 0) {")),
                            (), {}, False),
        "no_reload": (sub(src, ("const float xo = x[o], yo = y[o];",
                                "const float xo = xv, yo = yv;")),
                      (), {}, False),
        "no_barrier": (sub(src, ("        __syncthreads();\n\n"
                                 "        // Stage 1 along the row",
                                 "\n        // Stage 1 along the row")),
                       (), {}, False),
    }


def old_variants(src: str):
    return {
        "old": src,
        "old_no_grad_launch": sub(src, (
            "  ssim_grad_kernel<<<grid, block, 0, stream>>>(",
            "  if (h < 0) ssim_grad_kernel<<<grid, block, 0, stream>>>(")),
        "old_no_loss_launch": sub(src, (
            "  ssim_loss_kernel<<<1, kThreads, 0, stream>>>(",
            "  if (h < 0) ssim_loss_kernel<<<1, kThreads, 0, stream>>>(")),
        "old_no_window_copy": sub(src, (
            "  cudaError_t err = cudaMemcpyToSymbolAsync(c_win, window,",
            "  cudaError_t err = cudaSuccess; if (h < 0) err = "
            "cudaMemcpyToSymbolAsync(c_win, window,")),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-dir", default="")
    ap.add_argument("names", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(card)
    with open(os.path.join(kernels.CSRC_DIR, "ssim.cu")) as f:
        src = f.read()

    def wanted(name):
        return not args.names or any(n in name for n in args.names)

    pairs = {(h, w, dark): images(h, w, dark)
             for h, w in SIZES + SMALL for dark in (False, True)}
    for h, w in SIZES:
        x, y = pairs[(h, w, False)]
        ms = time_ms(lambda: ssim.fused_photometric_plain(x, y, 0.2), 5)
        log(f"plain version at {w}x{h}: {ms:.3f} ms")

    if wanted("fma_peak"):
        fma_peak()
    for name, (vsrc, flags, kw, right) in make_variants(src).items():
        if not wanted(name):
            continue
        lib, ptxas = build(name, vsrc, flags)
        if name == "committed":
            sass_mix(name)
        fn = New(lib, **kw)
        log(f"--- {name}: {'; '.join(ptxas)}; {fn.per_sm} resident blocks "
            f"per SM of {fn.threads} threads")
        for h, w in SIZES:
            x, y = pairs[(h, w, False)]
            strips, rows, down = fn.plan(h, w)
            log(f"{name} at {w}x{h}: {time_ms(lambda: fn(x, y)):.4f} ms "
                f"({strips} strips x {down} blocks of {rows} rows x 3)")
        if not right:
            continue
        for (h, w, dark), (x, y) in pairs.items():
            e = errors(fn, x, y)
            log(f"{name} {w}x{h}{' dark' if dark else ''}: " + ", ".join(
                f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
                for k, v in e.items()))
            assert e["finite"], (name, h, w, dark)
            assert e["d_loss_vs_plain"] <= 2e-6, (name, h, w, dark, e)
            assert e["d_grad_vs_plain"] <= 1e-4, (name, h, w, dark, e)
        # Two launches in a row agree bit for bit (the loss sum is
        # ordered).
        x, y = pairs[(SIZES[0][0], SIZES[0][1], False)]
        l1, g1 = fn(x, y)
        l2, g2 = fn(x, y)
        torch.cuda.synchronize()
        assert float(l1) == float(l2) and torch.equal(g1, g2), name

    if args.old_dir:
        with open(os.path.join(args.old_dir, "ssim.cu")) as f:
            old_src = f.read()
        for name, vsrc in old_variants(old_src).items():
            if not wanted(name):
                continue
            lib, ptxas = build(name, vsrc, ("-fmad=false",))
            fn = Old(lib)
            for h, w in SIZES:
                x, y = pairs[(h, w, False)]
                log(f"{name} at {w}x{h}: {time_ms(lambda: fn(x, y)):.4f} ms")
            if name == "old":
                for (h, w, dark) in ((900, 1600, False), (900, 1600, True)):
                    e = errors(fn, *pairs[(h, w, dark)])
                    log(f"{name} {w}x{h}{' dark' if dark else ''}: "
                        + ", ".join(f"{k} {v:.3e}" if isinstance(v, float)
                                    else f"{k} {v}" for k, v in e.items()))
    log("done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
