#!/usr/bin/env python3
"""A longer training run with the fused SSIM loss (K3) beside the same run
with the plain loss, on one NVIDIA GPU.

Writes the synthetic chunk of ``chip_smoke.py`` (1,000,000 points, 24 views
at 1600x900, scaffold and bounds) and trains it twice through
``h3dgs_tpu_torch.cli.train_single.main`` with the reference's default
schedule (densification from iteration 500 every 100, no opacity reset
before 3000): first with ``H3DGS_FUSED_SSIM=1``, then with the plain loss.
Every step's loss is read; the script reports whether all were finite (and
the first iteration that was not), the loss at the start and the end, the
median step time between step ends (CUDA events) and the it/s of each run.
It exits 1 if a fused-loss step was not finite. The fused loss stays off by
default whatever this shows: ``utils/losses._FUSED_SSIM_VERIFIED`` is the
switch a later change would flip.

Run: python3 scripts/torch_fused_long_run.py [--iterations 2500]
(from the repository root; about 6 minutes per 2,500 iterations and run)
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iterations", type=int, default=2500)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    cs.log(cs.card_line())
    cs.build_kernels()
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "chunk")
        sc_dir = cs.write_chunk(src, np.random.default_rng(0))
        base = ["-s", src, "--scaffold_file", sc_dir, "--bounds_file", src,
                "--skybox_locked", "--depths", "depths", "--device",
                cs.DEVICE, "--disable_viewer", "--iterations",
                str(args.iterations)]
        for fused in (True, False):
            name = "fused SSIM (K3)" if fused else "plain loss"
            t0 = time.perf_counter()
            rec, counts = cs.counted(cs.run_train_cli, base + [
                "-m", os.path.join(tmp, "fused" if fused else "plain")],
                fused=fused)
            wall = time.perf_counter() - t0
            photo = rec["photo"]
            bad = [i + 1 for i, v in enumerate(photo)
                   if not math.isfinite(v)]
            steady = rec["step_ms"][4:]
            cs.log(f"{name}: {len(photo)} iterations in {wall:.1f} s; "
                   f"every loss finite: {not bad}"
                   + (f" (first non-finite at iteration {bad[0]})"
                      if bad else "")
                   + f"; photo loss first 50 mean {np.mean(photo[:50]):.5f}"
                   f", last 50 mean {np.mean(photo[-50:]):.5f}; median step "
                   f"{np.median(steady):.3f} ms, "
                   f"{1e3 / np.median(steady):.2f} it/s; final alive "
                   f"{int(rec['state'].n_alive)}; kernel launches {counts}")
            if fused:
                ok = not bad and counts["ssim"] == len(photo)
            del rec
            torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
