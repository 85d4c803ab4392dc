#!/usr/bin/env python3
"""What the view stream costs the training loop at one and at several views
a step, on one NVIDIA GPU.

Writes the synthetic chunk of ``chip_smoke.py`` (1,000,000 points, 24 views
at 1600x900 with inverse depths, scaffold and bounds) and trains it through
``h3dgs_tpu_torch.cli.train_single.main`` four times: one view and
``--views_per_step`` views a step, each with the loop's own view stream
(PNG decoding in its thread pool while the steps run) and with a stream
whose views were all decoded before the first step (the same views in the
same order, so the loop decodes nothing while it trains; both encode each
view for its transfer in the loop's prefetcher). For each run it reports the median step time between step
ends (CUDA events, iterations 6 on) and the views per second; the gap
between the two streams is what the view stream costs the loop.

Run: python3 scripts/torch_dp_loop_experiment.py [--iterations 40]
     [--views_per_step 4]
(from the repository root; about 3 minutes)
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


class DecodedViews:
    """A view stream over views decoded in advance."""

    def __init__(self, views):
        self._views = iter(views)

    def __next__(self):
        return next(self._views)

    def close(self):
        pass


def decoded_in_advance(n_views: int):
    """A ``Scene.train_stream`` that draws ``n_views`` views from the
    scene's own stream before returning them as a stream."""
    from h3dgs_tpu_torch.scene.scene import Scene

    make = Scene.train_stream

    def train_stream(self, **kw):
        stream = make(self, **kw)
        views = [next(stream) for _ in range(n_views)]
        stream.close()
        return DecodedViews(views)
    return train_stream


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iterations", type=int, default=40)
    ap.add_argument("--views_per_step", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from h3dgs_tpu_torch.scene.scene import Scene

    cs.log(cs.card_line())
    cs.build_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "chunk")
        sc_dir = cs.write_chunk(src, np.random.default_rng(0))
        base = ["-s", src, "--scaffold_file", sc_dir, "--bounds_file", src,
                "--skybox_locked", "--depths", "depths", "--device",
                cs.DEVICE, "--iterations", str(args.iterations)]
        base += cs.TRAIN_FLAGS
        for views in (1, args.views_per_step):
            for advance in (False, True):
                own = Scene.train_stream
                if advance:
                    # One window more than the steps take: the loop's
                    # prefetcher stays a window ahead.
                    Scene.train_stream = decoded_in_advance(
                        (args.iterations + 1) * views)
                try:
                    rec, counts = cs.counted(cs.run_train_cli, base + [
                        "-m", os.path.join(tmp, f"v{views}_{advance}"),
                        "--views_per_step", str(views)])
                finally:
                    Scene.train_stream = own
                med = float(np.median(cs.steady_ms(rec)[0]))
                cs.log(f"{views} view(s) a step, "
                       f"{'views decoded in advance' if advance else 'the loop stream'}"
                       f": median step {med:.3f} ms, {views * 1e3 / med:.2f}"
                       f" views/s; kernel launches {counts}")
                del rec
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
