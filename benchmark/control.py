"""Read the controls of a cell: the compared numbers with the plain
reference computed in a lower precision put in the program's place (and,
for training, planted faults), on each given seed, at the cell's own
size. One JSON line per seed.

Usage: python benchmark/control.py --workload <cell> --seeds <n> [<n> ...]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def read(workload: str, seed: int, device, config_override=None,
         traffic_override=None) -> dict:
    sys.path.insert(0, ROOT)
    from benchmark import run
    cell = run.Cell(ROOT, workload, seed, 0.0, False, device,
                    config_override, traffic_override)
    try:
        return cell.driver.control(cell)
    finally:
        cell.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    for seed in a.seeds:
        out = read(a.workload, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": a.workload, "seed": seed, **out}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
