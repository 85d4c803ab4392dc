"""A cell, a configuration, a traffic mix and a metric dropped in as
files are found by name, with no edit to the harness."""
from __future__ import annotations

import json
import os
import shutil

import torch

from _tiny import ROOT


def test_files_found_by_name(tmp_path):
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    base = root / "benchmark"
    (base / "configs" / "hier_small.json").write_text(json.dumps(
        dict(json.loads((base / "configs" / "hier_2chunk.json").read_text()),
             gaussians_per_chunk=5000)))
    (base / "traffic" / "walk_slow.json").write_text(json.dumps(
        dict(json.loads((base / "traffic" / "walk.json").read_text()),
             warmup=2)))
    (base / "limits" / "serve_small.json").write_text(
        (base / "limits" / "serve_walk.json").read_text())
    (base / "metrics" / "serve.frames_counted.py").write_text(
        "def read(view):\n    return len(view['res']['latency_s'])\n")
    bench["configs"].append(dict(bench["configs"][1], name="hier_small",
                                 file="benchmark/configs/hier_small.json"))
    bench["workloads"].append({"name": "serve_small", "config": "hier_small",
                               "traffic": "walk_slow", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({
        "name": "serve.frames_counted", "unit": "frames", "better": "higher",
        "source": "program_counter", "layer": "cut cache",
        "moves": "frames_per_s", "workloads": ["serve_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    from benchmark import run
    cell = run.Cell(str(root), "serve_small", 3, 1.0, False,
                    torch.device("cpu"))
    try:
        assert cell.config["gaussians_per_chunk"] == 5000
        assert cell.traffic["warmup"] == 2
        assert cell.driver.__file__ == str(base / "paths" / "serve.py")
        assert "bad_pixel_share" in cell.limits["numbers"]
        names = [m["name"] for m in run.metrics_of(cell, "per_layer")]
        assert names == ["serve.frames_counted"]
        e2e = [m["name"] for m in run.metrics_of(cell, "end_to_end")]
        assert e2e == ["setup_s"]
        got = run.read_metrics(cell, run.metrics_of(cell, "per_layer"),
                               {"res": {"latency_s": [0.1] * 7}})
        assert got == {"serve.frames_counted": {"value": 7.0,
                                                "unit": "frames"}}
    finally:
        cell.close()


def test_every_named_file_exists():
    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    base = os.path.join(ROOT, "benchmark")
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for w in bench["workloads"]:
        traffic = json.load(open(os.path.join(base, "traffic",
                                              w["traffic"] + ".json")))
        assert os.path.isfile(os.path.join(base, "paths",
                                           traffic["entry"] + ".py"))
        assert os.path.isfile(os.path.join(base, "limits",
                                           w["name"] + ".json"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(os.path.join(base, "metrics",
                                           m["name"] + ".py"))


def test_metric_without_workloads_follows_its_moves():
    """A per-layer metric that names no cells is read in every cell that
    reports the end-to-end metric it moves, cells added later included."""
    from types import SimpleNamespace

    from benchmark import run
    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    bench["per_layer"].append({
        "name": "serve.frames_counted", "unit": "frames", "better": "higher",
        "source": "program_counter", "layer": "cut cache",
        "moves": "frames_per_s"})
    bench["end_to_end"][1]["workloads"].append("serve_later")
    seen = {}
    for cell in ("serve_walk", "serve_look", "serve_later", "train_chunk"):
        c = SimpleNamespace(bench=bench, workload={"name": cell})
        seen[cell] = "serve.frames_counted" in [
            m["name"] for m in run.metrics_of(c, "per_layer")]
    assert seen == {"serve_walk": True, "serve_look": True,
                    "serve_later": True, "train_chunk": False}
