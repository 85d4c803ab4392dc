"""Tiny sizes of the cells for the CPU tests, and helpers to run a cell
in this process or in a fresh interpreter."""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CONFIG = {
    "train_chunk": dict(gaussians=3000, skybox=50, scaffold=300, views=6,
                        width=64, height=48, points3d=500,
                        capacity_factor=2.0),
    "serve_walk": dict(gaussians_per_chunk=3000, width=96, height=64),
    "serve_look": dict(gaussians_per_chunk=3000, width=96, height=64),
}
CONFIG["post_chunk"] = CONFIG["train_chunk"]
# Training enters 15 steps before the densify pass at 7200, so that a
# short window holds it; the serving cells check every frame.
TRAFFIC = {
    "train_chunk": dict(start_iteration=7185),
    "serve_walk": dict(check_every=1, control_frames=3),
    "serve_look": dict(check_every=1, control_frames=3),
    "post_chunk": {},
}
SECONDS = {"train_chunk": 4.0, "serve_walk": 4.0, "serve_look": 4.0,
           "post_chunk": 4.0}
SEED = 2 ** 31 + 12345


def cell(workload: str, seed: int = SEED, trace: bool = False):
    import torch
    from benchmark import run
    return run.Cell(ROOT, workload, seed, SECONDS[workload], trace,
                    torch.device("cpu"), CONFIG[workload], TRAFFIC[workload])


def run_in_process(workload: str, seed: int = SEED, trace: bool = False):
    """The result line's object of one tiny CPU run (no import guard:
    the test process may hold JAX)."""
    from benchmark import run
    c = cell(workload, seed, trace)
    try:
        return run.run_cell(c)
    finally:
        c.close()


def run_in_child(workload: str, trace: int = 0, extra: str = ""):
    """``benchmark/run.py``'s main in a fresh interpreter on the CPU.
    Returns (exit code, stdout, stderr)."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from benchmark import run\n"
        f"{extra}\n"
        f"sys.exit(run.main(['--workload', {workload!r}, '--seed', "
        f"'{SEED}', '--seconds', '{SECONDS[workload]}', '--trace', "
        f"'{trace}'], device='cpu', "
        f"config_override=json.loads({json.dumps(json.dumps(CONFIG[workload]))}), "
        f"traffic_override=json.loads({json.dumps(json.dumps(TRAFFIC[workload]))})))\n")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT, env=env)
    return p.returncode, p.stdout, p.stderr
