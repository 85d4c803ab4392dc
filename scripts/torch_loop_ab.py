#!/usr/bin/env python3
"""One-view training loops of two trees of the repository, back to back on
one NVIDIA GPU.

Writes the synthetic chunk of ``chip_smoke.py`` (1,000,000 points, 24
views at 1600x900 with inverse depths, scaffold and bounds), trains it one
step with this tree's ``train_single`` to get a Gaussian point cloud, and
builds its hierarchy with this tree's ``hierarchy_creator``. Then, for each
tree named in ``--order``, a child process imports that tree's
``chip_smoke.py`` and package (and nothing of this tree) and trains the
chunk one view a step through that tree's ``cli/train_single`` and
``cli/train_post`` (plain loss, no checkpoint). It reports each run's
median step time between step ends (CUDA events, the intervals ending at
iteration 6 or later, as ``chip_smoke.py`` reads them). Comparing two trees
in one call, in the order a, b, b, a, keeps the host the same for both.

Run: python3 scripts/torch_loop_ab.py OTHER_TREE [--order abba]
     [--iterations 40]
(from the repository root; ``a`` is OTHER_TREE, ``b`` this tree; about
10 minutes)
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def setup(data: str) -> None:
    """The chunk, a trained point cloud and its hierarchy, with this
    tree's code."""
    import numpy as np
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from h3dgs_tpu_torch.cli import hierarchy_creator, train_single

    src = os.path.join(data, "chunk")
    sc_dir = cs.write_chunk(src, np.random.default_rng(0))
    flat = os.path.join(data, "flat")
    train_single.main(["-s", src, "--scaffold_file", sc_dir,
                       "--bounds_file", src, "--skybox_locked", "--depths",
                       "depths", "--device", cs.DEVICE, "-m", flat,
                       "--iterations", "1"] + cs.TRAIN_FLAGS)
    ply = os.path.join(flat, "point_cloud", "iteration_1",
                       "point_cloud.ply")
    hierarchy_creator.main([ply, src, flat, sc_dir, "--backend", "native"])


def child(root: str, data: str, iterations: int) -> None:
    """Both one-view loops of the tree at ``root``; prints one JSON line."""
    import numpy as np
    sys.path.insert(0, root)
    import chip_smoke as cs

    src = os.path.join(data, "chunk")
    sc_dir = os.path.join(src, "scaffold")
    run = tempfile.mkdtemp(dir=data)
    flat = cs.run_train_cli([
        "-s", src, "--scaffold_file", sc_dir, "--bounds_file", src,
        "--skybox_locked", "--depths", "depths", "--device", cs.DEVICE,
        "-m", os.path.join(run, "flat"), "--iterations", str(iterations)]
        + cs.TRAIN_FLAGS)
    post = cs.run_post_cli([
        "-s", src, "--hierarchy", os.path.join(data, "flat",
                                               "hierarchy.hier"),
        "--scaffold_file", sc_dir, "--skybox_locked", "--device",
        cs.DEVICE, "-m", os.path.join(run, "post"), "--iterations",
        str(iterations)])
    print(json.dumps({
        "root": root,
        "flat_median_ms": float(np.median(flat["step_ms"][4:])),
        "post_median_ms": float(np.median(post["step_ms"][4:]))}),
        flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--order", default="abba")
    ap.add_argument("--iterations", type=int, default=40)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--data", help=argparse.SUPPRESS)
    ap.add_argument("--setup", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.setup:
        setup(args.data)
        return 0
    if args.child:
        child(args.child, args.data, args.iterations)
        return 0
    roots = {"a": os.path.abspath(args.other), "b": HERE}
    me = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as data:
        subprocess.run([sys.executable, me, "--setup", "--data", data],
                       check=True)
        results = []
        for key in args.order:
            out = subprocess.run(
                [sys.executable, me, "--child", roots[key], "--data", data,
                 "--iterations", str(args.iterations)],
                check=True, stdout=subprocess.PIPE, text=True).stdout
            line = json.loads(out.strip().splitlines()[-1])
            line["tree"] = key
            results.append(line)
            print(json.dumps(line), flush=True)
    for key in sorted(set(args.order)):
        runs = [r for r in results if r["tree"] == key]
        print(f"{key} ({roots[key]}): flat median "
              f"{[round(r['flat_median_ms'], 3) for r in runs]} ms, post "
              f"median {[round(r['post_median_ms'], 3) for r in runs]} ms",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
