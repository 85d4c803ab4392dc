#!/usr/bin/env python3
"""Floor experiments on the port's blend kernels (K1 forward, K2 backward),
on one NVIDIA GPU.

Builds variants of ``h3dgs_tpu_torch/csrc/blend_{fwd,bwd}.cu`` by text
substitution (the cull switched off, the cross-lane reduction or the
flush removed, other occupancy targets and batch sizes), times each on the
same inputs, and holds every variant that still computes the function
against the committed kernel. The inputs are the 1,000,000-Gaussian
surface of ``chip_smoke.py`` projected and binned for a 1920x1080 orbit
camera (K1) and a 1600x900 training camera (K2, random cotangents). Also
timed: the tiles taken deepest first against raster order, the launch
restricted to the deepest k tiles (the critical path of one launch), and
the pack pre-pass against ``torch.cat`` at 1M and 8.1M rows.

With ``--old-dir DIR`` it also builds and times an earlier design whose
``blend_fwd.cu`` and ``blend_bwd.cu`` lie in DIR (the per-column entry
points of the first port, e.g. ``git show <commit>:h3dgs_tpu_torch/csrc/
blend_bwd.cu > DIR/blend_bwd.cu``), with its reduction and its atomics
removed, and holds the committed kernels against it.

Run: python3 scripts/torch_blend_experiments.py [--old-dir DIR] [name ...]
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
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from h3dgs_tpu_torch.ops import blend, kernels  # noqa: E402
from h3dgs_tpu_torch.ops.binning import bin_gaussians  # noqa: E402
from h3dgs_tpu_torch.ops.projection import project_gaussians  # noqa: E402
from h3dgs_tpu_torch.ops.rasterize import blend_args  # noqa: E402
from h3dgs_tpu_torch.scene.camera import look_at_camera  # noqa: E402

BUILD = os.path.join(kernels.BUILD_DIR, "experiments")
V, I = ctypes.c_void_p, ctypes.c_int
NEW_FWD_ARGS = [V] * 5 + [I] + [V] * 5 + [I] * 4 + [V] * 5
NEW_BWD_ARGS = [V] * 5 + [I] + [V] + [I] + [V] * 3 + [I] * 4 + [V] * 7
OLD_FWD_ARGS = [V] * 8 + [I] * 4 + [V] * 5
OLD_BWD_ARGS = [V] * 7 + [I] * 4 + [V] * 7
SINK = "123.456f"  # a value no input takes: keeps a removed part's inputs live


def log(*parts) -> None:
    print(" ".join(str(p) for p in parts), flush=True)


def read(path: str) -> str:
    with open(path) as f:
        return f.read()


def sub(src: str, *pairs) -> str:
    for old, new in pairs:
        assert old in src, f"pattern not in source: {old!r}"
        src = src.replace(old, new)
    return src


def make_variants(old_dir):
    """name -> (source, header or None, kind)."""
    csrc = kernels.CSRC_DIR
    header = read(os.path.join(csrc, "blend_common.cuh"))
    no_cull = sub(header, ("  const float dx0 = x0 - a.x, dx1 = a.x - x1;",
                           "  return false;\n"
                           "  const float dx0 = x0 - a.x, dx1 = a.x - x1;"))
    fwd = read(os.path.join(csrc, "blend_fwd.cu"))
    bwd = read(os.path.join(csrc, "blend_bwd.cu"))
    end = "  cp_async_wait<0>();\n}\n\n}  // namespace"
    any_contrib = "if (__any_sync(kFullMask, e0.ok || e1.ok)) {"
    out = {
        "new_fwd": (fwd, header, "new_fwd"),
        "new_fwd_nocull": (fwd, no_cull, "new_fwd"),
        "new_bwd": (bwd, header, "new_bwd"),
        "new_bwd_nocull": (bwd, no_cull, "new_bwd"),
        "new_bwd_noreduce": (sub(
            bwd, (any_contrib, "if (__any_sync(kFullMask, e0.ok || e1.ok) "
                               "&& tid == 999) {"),
            (end, end.replace("}\n\n}", f"  if (T == {SINK}) grads[0] = "
                              "suffix;\n}\n\n}", 1))), header, "new_bwd"),
        "new_bwd_noflush": (sub(bwd, ("      if (any) {",
                                      f"      if (any && r0.x == {SINK}) {{")),
                            header, "new_bwd"),
        "new_bwd_batch64": (sub(bwd, ("kBatch = 128", "kBatch = 64")),
                            header, "new_bwd"),
    }
    for blocks in (3, 4, 6):
        out[f"new_bwd_minblocks{blocks}"] = (
            sub(bwd, ("kMinBlocks = 5", f"kMinBlocks = {blocks}")), header,
            "new_bwd")
    if old_dir:
        old_f = read(os.path.join(old_dir, "blend_fwd.cu"))
        old_b = read(os.path.join(old_dir, "blend_bwd.cu"))
        tail = "  }\n}\n\n}  // namespace"
        out.update({
            "old_fwd": (old_f, None, "old_fwd"),
            "old_fwd_nocolor": (sub(
                old_f, ("c0 += w * s_r[j];", ""), ("c1 += w * s_g[j];", ""),
                ("c2 += w * s_b[j];", ""), ("dsum += w * s_id[j];", "")),
                None, "old_fwd"),
            "old_bwd": (old_b, None, "old_bwd"),
            "old_bwd_noreduce": (sub(
                old_b, ("if (__any_sync(kFullMask, contrib)) {",
                        "if (__any_sync(kFullMask, contrib) && tid == 999) {"),
                (tail, f"  }}\n  if (T == {SINK}) grads[0] = suffix;\n}}\n\n"
                       "}  // namespace")), None, "old_bwd"),
            "old_bwd_noatomics": (sub(
                old_b, ("        if (lane == 0) {",
                        f"        if (lane == 0 && v[0] == {SINK}) {{")),
                None, "old_bwd"),
        })
    return out


def build(variants):
    """One nvcc per variant, all started together; prints ptxas's report."""
    procs = {}
    t0 = time.perf_counter()
    for name, (src, header, _) in variants.items():
        d = os.path.join(BUILD, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "k.cu"), "w") as f:
            f.write(src)
        if header:
            with open(os.path.join(d, "blend_common.cuh"), "w") as f:
                f.write(header)
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o",
               os.path.join(d, "k.so"), os.path.join(d, "k.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            log(f"BUILD FAILED {name}:\n{out}")
            continue
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
        libs[name] = ctypes.CDLL(os.path.join(BUILD, name, "k.so"))
    log(f"builds: {time.perf_counter() - t0:.1f} s")
    return libs


def scene_inputs(cam):
    rng = np.random.default_rng(0)
    xyz, shs, alpha, scaling, rotation = cs.make_scene(rng, 1_000_000)
    t = [torch.as_tensor(a, device="cuda")
         for a in (xyz, np.exp(scaling), rotation, alpha, shs)]
    with torch.no_grad():
        proj = project_gaussians(*t, cam.to("cuda"), 3)
        return blend_args(proj, bin_gaussians(proj, cam.height, cam.width))


def stream():
    return torch.cuda.current_stream().cuda_stream


def ptrs(*tensors):
    return [None if t is None else t.data_ptr() for t in tensors]


class View:
    """One view's inputs, forward outputs and cotangents on the card."""

    def __init__(self, cam, libs):
        self.h, self.w = cam.height, cam.width
        self.args = scene_inputs(cam)
        self.tiles_x = -(-self.w // 16)
        tc = self.args[7]
        self.n_tiles = tc.numel()
        self.order = blend.tile_order(tc)
        self.raster = torch.arange(self.n_tiles, device="cuda")
        self.libs = libs
        self.fwd, self.rows = blend._launch_blend_fwd(
            *self.args, self.order, self.h, self.w)
        gen = torch.Generator(device="cuda").manual_seed(1)
        self.cot = tuple(
            torch.randn(s, generator=gen, device="cuda") * 1e-6
            for s in ((3, self.h, self.w), (1, self.h, self.w),
                      (self.h, self.w)))
        log(f"{self.w}x{self.h}: {self.args[5].numel()} entries, deepest "
            f"tile {int(tc.max())}, mean {float(tc.float().mean()):.1f}")

    def forward(self, name, kind, order, n_tiles=None):
        cols, (gi, ts, tc) = self.args[:5], self.args[5:]
        n_tiles = self.n_tiles if n_tiles is None else n_tiles
        out = (torch.empty((3, self.h, self.w), device="cuda"),
               torch.empty((1, self.h, self.w), device="cuda"),
               torch.empty((self.h, self.w), device="cuda"),
               torch.empty((self.h, self.w), dtype=torch.int32,
                           device="cuda"))
        fn = self.libs[name].blend_fwd_launch
        fn.restype = I
        if kind == "old_fwd":
            fn.argtypes = OLD_FWD_ARGS
            st = fn(*ptrs(*cols, gi, ts, tc), n_tiles, self.tiles_x, self.h,
                    self.w, *ptrs(*out), stream())
        else:
            fn.argtypes = NEW_FWD_ARGS
            st = fn(*ptrs(*cols), cols[0].shape[0], *ptrs(self.rows, gi, ts,
                                                          tc, order),
                    n_tiles, self.tiles_x, self.h, self.w, *ptrs(*out),
                    stream())
        assert st == 0, (name, st)
        return out

    def backward(self, name, kind, order, n_tiles=None):
        cols, (gi, ts, _) = self.args[:5], self.args[5:]
        n_tiles = self.n_tiles if n_tiles is None else n_tiles
        n = cols[0].shape[0]
        pix = (self.fwd[2], self.fwd[3], *self.cot)
        fn = self.libs[name].blend_bwd_launch
        fn.restype = I
        if kind == "old_bwd":
            grads = torch.zeros((n, 10), device="cuda")
            fn.argtypes = OLD_BWD_ARGS
            st = fn(*ptrs(*cols, gi, ts), n_tiles, self.tiles_x, self.h,
                    self.w, *ptrs(*pix, grads), stream())
            assert st == 0, (name, st)
            return (grads[:, 0:2], grads[:, 2:5], grads[:, 5:8], grads[:, 8],
                    grads[:, 9])
        grads = torch.zeros((n, blend.ROW_COLS), device="cuda")
        fn.argtypes = NEW_BWD_ARGS
        st = fn(None, None, None, None, None, n, self.rows.data_ptr(), 0,
                *ptrs(gi, ts, order), n_tiles, self.tiles_x, self.h, self.w,
                *ptrs(*pix, grads), stream())
        assert st == 0, (name, st)
        return blend.unpack_grads(grads)


def occupancy(lib, kind):
    fn = getattr(lib, {"new_fwd": "blend_fwd_occupancy",
                       "new_bwd": "blend_bwd_occupancy"}[kind])
    fn.restype = I
    fn.argtypes = [ctypes.POINTER(I)] * 2
    blocks, threads = I(0), I(0)
    fn(ctypes.byref(blocks), ctypes.byref(threads))
    return f"{blocks.value} blocks/SM x {threads.value} threads"


def time_view(view, variants, libs, direction):
    """Every built variant of one direction on one view; the reference for
    the comparison is the old kernel when there is one, else the committed
    new one."""
    run = view.forward if direction == "fwd" else view.backward
    names = [n for n, v in variants.items()
             if n in libs and v[2].endswith(direction)]
    ref_name = next((n for n in (f"old_{direction}", f"new_{direction}")
                     if n in names), None)
    ref = None
    if ref_name:
        kind = variants[ref_name][2]
        ref = run(ref_name, kind, view.order if kind.startswith("new")
                  else None)
        torch.cuda.synchronize()
    for name in names:
        kind = variants[name][2]
        orders = ((("deepest first", view.order), ("raster", view.raster))
                  if kind.startswith("new") else (("raster", None),))
        whole = name in (f"old_{direction}", f"new_{direction}") or \
            name.endswith(("cull", "batch64")) or "minblocks" in name
        for label, order in orders:
            out = run(name, kind, order)
            torch.cuda.synchronize()
            msg = ""
            if whole and ref is not None and direction == "fwd":
                d = max(float((a - b).abs().max())
                        for a, b in zip(out[:3], ref[:3]))
                eq = float((out[3] == ref[3]).float().mean())
                msg = f"max |d| vs {ref_name} {d:.3e}, last equal {eq:.6f}"
            elif whole and ref is not None:
                close = [cs._close_grads(a, b)[:2] for a, b in zip(out, ref)]
                mask = bool(((out[3] != 0) == (ref[3] != 0)).all())
                msg = (f"vs {ref_name}: worst max |d| / max |g| "
                       f"{max(c[0] for c in close):.3e}, least cosine "
                       f"{min(c[1] for c in close):.9f}, mask equal {mask}")
            ms = cs.time_ms(lambda: run(name, kind, order), 20)
            occ = occupancy(libs[name], kind) if kind.startswith("new") \
                else ""
            log(f"{name:24s} {label:13s} {ms:.4f} ms  {msg}  {occ}")
    # The critical path: the launch on the deepest k tiles alone.
    for name in names:
        kind = variants[name][2]
        if not kind.startswith("new"):
            continue
        depth = view.args[7][view.order]
        ks = [k for k in (1, 132, 1056) if k < view.n_tiles] + [view.n_tiles]
        log(f"{name} on the deepest k tiles alone (depths {int(depth[0])}.."
            f"): " + ", ".join(
                f"k={k}: {cs.time_ms(lambda: run(name, kind, view.order, k), 10):.4f} ms"
                for k in ks))


def time_pack(n: int) -> None:
    cols = [torch.rand((n, c), device="cuda") if c
            else torch.rand((n,), device="cuda") for c in (2, 3, 3, 0, 0)]
    rows = blend.pack_rows(*cols)
    equal = torch.equal(rows, blend.pack_rows_plain(*cols))
    log(f"pack pre-pass, {n} rows: {cs.time_ms(lambda: blend.pack_rows(*cols), 20):.4f} ms; "
        f"torch.cat {cs.time_ms(lambda: blend.pack_rows_plain(*cols), 10):.4f} ms; "
        f"equal: {equal}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-dir", help="directory with an earlier design's "
                                      "blend_fwd.cu and blend_bwd.cu")
    ap.add_argument("names", nargs="*", help="build only variants whose "
                                             "name contains one of these")
    ns = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    log(cs.card_line())
    variants = make_variants(ns.old_dir)
    if ns.names:
        variants = {k: v for k, v in variants.items()
                    if any(s in k for s in ns.names)
                    or k in ("new_fwd", "new_bwd")}
    libs = build(variants)
    for n in (1_000_000, 8_100_000):
        time_pack(n)

    view = View(cs.orbit_cams(look_at_camera)[-1], libs)
    log(f"tile sort: {cs.time_ms(lambda: blend.tile_order(view.args[7]), 20):.4f} ms")
    time_view(view, variants, libs, "fwd")
    del view
    torch.cuda.empty_cache()
    view = View(cs.train_cameras(look_at_camera)[0], libs)
    time_view(view, variants, libs, "bwd")
    return 0


if __name__ == "__main__":
    sys.exit(main())
