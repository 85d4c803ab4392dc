"""Run one cell of the benchmark once and print its result line.

Usage (from the repository root, on a machine with the cell's cards):

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is looked up by name in ``BENCHMARK.json``; its configuration
(``benchmark/configs/<config>.json``), its traffic
(``benchmark/traffic/<traffic>.json``, whose ``entry`` names the driver
``benchmark/paths/<entry>.py``), its limits
(``benchmark/limits/<cell>.json``) and each metric's reader
(``benchmark/metrics/<metric>.py``) are found by name, so a cell, a
configuration or a metric is added by adding files. ``--trace 0`` prints
the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from a
``torch.profiler`` trace of the window. Either run checks what the timed
path produced against the plain reference (``benchmark/reference/``) and
prints each compared number beside its limit, last on standard error and
last in the result line.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "h3dgs_tpu")


def cache_env(root: str) -> None:
    """Fixed build and kernel cache directories inside the checkout."""
    base = os.path.join(root, "benchmark", "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``h3dgs_tpu_torch`` is not ``h3dgs_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


class Cell:
    """Everything a driver needs: the cell's files, the seed, the window
    and the hooks that mark it."""

    def __init__(self, root: str, workload: str, seed: int, seconds: float,
                 trace: bool, device, config_override=None,
                 traffic_override=None):
        self.root = root
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}")
        self.bench = bench
        self.workload = cells[workload]
        base = os.path.join(root, "benchmark")
        self.config = load_json(os.path.join(
            base, "configs", self.workload["config"] + ".json"))
        if config_override:
            self.config.update(config_override)
        self.traffic = load_json(os.path.join(
            base, "traffic", self.workload["traffic"] + ".json"))
        if traffic_override:
            self.traffic.update(traffic_override)
        self.limits = load_json(os.path.join(base, "limits",
                                             workload + ".json"))
        self.driver = load_module(
            os.path.join(base, "paths", self.traffic["entry"] + ".py"),
            "benchmark.paths." + self.traffic["entry"])
        self.seed, self.seconds, self.device = seed, seconds, device
        self.tmp = tempfile.mkdtemp(prefix="h3dgs-bench-")
        self.profiler = None
        if trace:
            from benchmark.core.trace import Profiler
            self.profiler = Profiler(os.path.join(self.tmp, "trace.json"))
        self.setup_s = None
        self.memory_peak = 0

    def window_started(self) -> None:
        """Set-up ends; with ``--trace 1`` the profiler starts (on the
        calling thread, whose ranges it records)."""
        import torch
        self.setup_s = time.perf_counter() - T_START
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        if self.profiler is not None:
            self.profiler.start()
            self.t_trace = time.perf_counter()

    def window_closed(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.memory_peak = int(torch.cuda.max_memory_allocated(
                self.device))
        self.trace = None
        if self.profiler is not None:
            self.traced_s = time.perf_counter() - self.t_trace
            self.trace = self.profiler.stop()

    @staticmethod
    def free_port() -> int:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def metrics_of(cell: Cell, kind: str) -> list:
    """The cell's metric entries of ``kind`` ("end_to_end" or
    "per_layer")."""
    name = cell.workload["name"]
    mine = set()
    for m in cell.bench["end_to_end"]:
        if "workloads" not in m or name in m["workloads"]:
            mine.add(m["name"])
    out = []
    for m in cell.bench[kind]:
        if "workloads" in m:
            if name in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in mine:
            out.append(m)
    return out


def read_metrics(cell: Cell, entries: list, view: dict) -> dict:
    folder = os.path.join(cell.root, "benchmark", "metrics")
    if folder not in sys.path:
        sys.path.insert(0, folder)
    out = {}
    for m in entries:
        reader = load_module(os.path.join(cell.root, "benchmark", "metrics",
                                          m["name"] + ".py"),
                             "benchmark.metrics." + m["name"])
        got = reader.read(view)
        if got is None:
            continue
        if not isinstance(got, dict):
            got = {"value": got}
        out[m["name"]] = dict(got, value=float(got["value"]),
                              unit=m["unit"])
    return out


def compare(numbers: dict, limits: dict) -> tuple:
    """(correct, [[name, value, limit]]): every number at or under its
    limit; a number missing counts as failed."""
    rows, ok = [], True
    for name, spec in limits["numbers"].items():
        value = numbers.get(name)
        good = value is not None and value <= spec["limit"]
        ok &= good
        rows.append([name, value, spec["limit"]])
    return ok, rows


def run_cell(cell: Cell) -> dict:
    """Set up, run the window, check against the reference and read the
    metrics; returns the result line's object."""
    import torch
    res = cell.driver.run(cell)
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    print(f"setup {cell.setup_s:.3f} s, window closed at "
          f"{t_check - T_START:.3f} s", file=sys.stderr)
    check = cell.driver.reference_check(cell, res)
    print(f"reference check {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    numbers = cell.driver.compared_numbers(res, check)
    correct, rows = compare(numbers, cell.limits)
    view = {"cell": cell.workload["name"], "res": res, "check": check,
            "trace": cell.trace, "setup_s": cell.setup_s,
            "traced_s": getattr(cell, "traced_s", None),
            "power_limit_w": power_limit_w() if cell.trace else None}
    kind = "per_layer" if cell.trace is not None else "end_to_end"
    metrics = read_metrics(cell, metrics_of(cell, kind), view)
    dev = cell.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": cell.memory_peak}
    out = {"correct": bool(correct),
           "attempted": int(cell.driver.attempted(res)),
           "failed": int(cell.driver.failed(res)),
           "metrics": metrics, "device": device}
    if cell.trace is not None:
        device["busy_s"] = cell.trace.busy_s()
        device["window_s"] = float(cell.traced_s)
        out["breakdown"] = {"device_ops": cell.trace.top_ops(),
                            "idle_gaps": cell.trace.idle_gaps()}
    out["compared"] = {name: {"value": v, "limit": lim}
                       for name, v, lim in rows}
    return out


def main(argv=None, device=None, config_override=None,
         traffic_override=None) -> int:
    """The command. ``device`` (a CPU run for the tests, which skips the
    look for cards) and the overrides (tiny sizes) are for the tests."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cache_env(ROOT)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    if device is None:
        bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
        need = next((w["chips"] for w in bench["workloads"]
                     if w["name"] == a.workload), 1)
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"needs {need} CUDA card(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    cell = Cell(ROOT, a.workload, a.seed, a.seconds, bool(a.trace),
                torch.device(device), config_override, traffic_override)
    try:
        out = run_cell(cell)
    finally:
        cell.close()
    bad = forbidden_modules()
    if bad:
        print("the run loaded JAX or the JAX package: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    for name, v in out["compared"].items():
        print(f"compared {name}: {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
