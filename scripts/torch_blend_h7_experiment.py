#!/usr/bin/env python3
"""Where K2's distance from float64 on a deep tile comes from (hazard H7),
on one NVIDIA GPU.

``chip_smoke.py`` holds the blend backward kernel (K2, T recovered by
division) on the deepest tile of a trained view against the plain backward
in float64, and asks that it be no farther than the float32 plain version.
This script separates three things that could move that reading:

- the kernel giving different results on the same inputs (it sums with
  atomics; a race would show here): every sample launches K2 ``--reps``
  times on the same inputs and reports the spread;
- the float32 forward and the float64 reference walking different entries
  (an alpha within rounding of 1/255, a T within rounding of 1e-4): the
  two then differentiate different functions. ``chip_smoke``'s
  ``h7_forward_agreement`` marks such pixels; every sample is measured
  with all of the tile's pixels and again with the marked ones left out;
- rounding proper: what is left.

Samples: the synthetic chunk of ``chip_smoke.py`` is trained as there; of
``--views`` views, the ``--tiles`` deepest whole tiles each, cut out as a
one-tile problem (the tile's entries and Gaussians, means shifted by the
tile's origin, the view's own cotangents on its pixels), K1 run on it for
the forward; and, for the first ``--full`` views, the deepest tile inside
the whole image exactly as ``chip_smoke.py`` takes it.

Run: python3 scripts/torch_blend_h7_experiment.py [--views 24] [--tiles 20]
(from the repository root; about 7 minutes on an H100)
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

TILE = 16


def measure(args, cot, keep, h, w, reps):
    """One sample: K1 on ``args``, then the distances with every pixel of
    ``keep`` and with the pixels of differing walks left out."""
    from h3dgs_tpu_torch.ops.blend import blend_forward

    with torch.no_grad():
        fwd = tuple(t.detach() for t in blend_forward(*args, h, w))
        agree, fwd64 = cs.h7_forward_agreement(args, fwd, h, w)
        rec = {"differ": int((keep & ~agree).sum()),
               "all": cs.h7_distances(args, fwd, fwd64, cot, keep, h, w,
                                      reps)}
        rec["agreeing"] = (cs.h7_distances(args, fwd, fwd64, cot,
                                           keep & agree, h, w, reps)
                           if rec["differ"] else rec["all"])
    return rec


def one_tile_problem(args, cot, tile, w):
    """The sub-problem of one whole tile: its entries and Gaussians, means
    relative to the tile's origin, the cotangents of its pixels."""
    means2d, conic, rgb, opacity, inv_depth, gauss_idx, start, count = args
    tiles_x = -(-w // TILE)
    ty, tx = divmod(tile, tiles_x)
    s, n = int(start[tile]), int(count[tile])
    used, entries = torch.unique(gauss_idx[s:s + n].long(),
                                 return_inverse=True)
    origin = torch.tensor([tx * TILE, ty * TILE], dtype=torch.float32,
                          device=means2d.device)
    sub = ((means2d[used] - origin).contiguous(), conic[used].contiguous(),
           rgb[used].contiguous(), opacity[used].contiguous(),
           inv_depth[used].contiguous(), entries.int().contiguous(),
           torch.zeros(1, dtype=torch.int32, device=means2d.device),
           torch.full((1,), n, dtype=torch.int32, device=means2d.device))
    ys = slice(ty * TILE, (ty + 1) * TILE)
    xs = slice(tx * TILE, (tx + 1) * TILE)
    return sub, tuple(c[..., ys, xs].contiguous() for c in cot), n


def report(what, n_entries, rec):
    ks_all = [max(r) for r in rec["all"]["kernel"]]
    ks = [max(r) for r in rec["agreeing"]["kernel"]]
    cs.log(f"{what}: {n_entries} entries, {rec['differ']} pixels of "
           f"differing walks; worst output against float64, all pixels: "
           f"kernel {min(ks_all):.3e} to {max(ks_all):.3e} over "
           f"{len(ks_all)} launches, float32 plain "
           f"{max(rec['all']['plain']):.3e}; agreeing pixels only: kernel "
           f"{min(ks):.3e} to {max(ks):.3e}, float32 plain "
           f"{max(rec['agreeing']['plain']):.3e}")


def summarise(name, recs):
    def worse(key):
        return [r for r in recs
                if max(max(k) for k in r[key]["kernel"])
                > max(r[key]["plain"])]

    spread = max((max(max(k) for k in r[key]["kernel"])
                  / max(min(max(k) for k in r[key]["kernel"]), 1e-30)
                  for r in recs for key in ("all", "agreeing")),
                 default=1.0)
    w_all, w_agree = worse("all"), worse("agreeing")
    with_diff = [r for r in recs if r["differ"]]
    cs.log(f"SUMMARY {name}: {len(recs)} samples, {len(with_diff)} with "
           f"pixels of differing walks; kernel farther from float64 than "
           f"the float32 plain version: {len(w_all)} with all pixels (of "
           f"them {sum(1 for r in w_all if r['differ'])} have such pixels),"
           f" {len(w_agree)} with the agreeing pixels only; largest ratio "
           f"of a sample's worst to its best launch {spread:.3f}")
    for key in ("all", "agreeing"):
        ratios = [max(max(k) for k in r[key]["kernel"]) / max(r[key]["plain"])
                  for r in recs if max(r[key]["plain"]) > 0]
        if ratios:
            cs.log(f"  kernel / float32 plain, {key} pixels: median "
                   f"{np.median(ratios):.4f}, 90th percentile "
                   f"{np.percentile(ratios, 90):.4f}, max "
                   f"{np.max(ratios):.4f}")
    return not w_agree


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=24)
    ap.add_argument("--tiles", type=int, default=20)
    ap.add_argument("--full", type=int, default=3)
    ap.add_argument("--reps", type=int, default=8)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from h3dgs_tpu_torch.config import OptimizationConfig
    from h3dgs_tpu_torch.scene.loader import load_view
    from h3dgs_tpu_torch.scene.views import stage_view, staged_to_device

    cs.log(cs.card_line())
    cs.build_kernels()
    tiles, fulls = [], []
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "chunk")
        sc_dir = cs.write_chunk(src, np.random.default_rng(0))
        rec = cs.run_train_cli([
            "-s", src, "--scaffold_file", sc_dir, "--bounds_file", src,
            "--skybox_locked", "--depths", "depths", "--device", cs.DEVICE,
            "-m", os.path.join(tmp, "model"), "--iterations",
            str(cs.TRAIN_ITERS)] + cs.TRAIN_FLAGS)
        state, scene = rec["state"], rec["scene"]
        cams = scene.info.train_cameras[:a.views]
        for v, cam in enumerate(cams):
            batch = staged_to_device(stage_view(load_view(cam, -1), pin=True),
                                     cs.DEVICE)
            _, k2 = cs.train_stage_times(state, batch, 0,
                                         OptimizationConfig(), reps=1)
            args, cot, h, w = k2[0], k2[5], k2[6], k2[7]
            count = args[7]
            tiles_x = -(-w // TILE)
            whole = torch.arange(count.numel(), device=count.device)
            whole = ((whole // tiles_x + 1) * TILE <= h) & \
                ((whole % tiles_x + 1) * TILE <= w)
            order = torch.argsort(torch.where(whole, count,
                                              torch.zeros_like(count)),
                                  descending=True)
            if v < a.full:
                deep = int(torch.argmax(count))
                ty, tx = divmod(deep, tiles_x)
                keep = torch.zeros((h, w), dtype=torch.bool,
                                   device=count.device)
                keep[ty * TILE:(ty + 1) * TILE,
                     tx * TILE:(tx + 1) * TILE] = True
                r = measure(args, cot, keep, h, w, a.reps)
                report(f"view {v}, deepest tile in the whole image",
                       int(count[deep]), r)
                fulls.append(r)
            for t in order[:a.tiles].tolist():
                sub, sub_cot, n = one_tile_problem(args, cot, t, w)
                keep = torch.ones((TILE, TILE), dtype=torch.bool,
                                  device=count.device)
                r = measure(sub, sub_cot, keep, TILE, TILE, a.reps)
                report(f"view {v}, tile {t} alone", n, r)
                tiles.append(r)
            del k2, args, cot, batch
            torch.cuda.empty_cache()
    ok = summarise("one-tile problems", tiles)
    if fulls:
        ok = summarise("deepest tile in the whole image", fulls) and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
