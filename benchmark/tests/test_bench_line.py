"""The result line's shape, and the compared numbers printed last."""
from __future__ import annotations

import json

import pytest

from _tiny import run_in_child


@pytest.mark.parametrize("workload,trace", [("serve_look", 0),
                                            ("serve_look", 1),
                                            ("serve_walk", 1),
                                            ("train_chunk", 1),
                                            ("post_chunk", 0)])
def test_last_line(workload, trace):
    rc, out, err = run_in_child(workload, trace)
    assert rc == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    for name, m in line["metrics"].items():
        assert set(m) >= {"value", "unit"}, name
        assert isinstance(m["value"], float)
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert "setup_s" not in line["metrics"]
        if workload == "serve_look":
            assert "serve.frame_p95_ms" in line["metrics"]
            assert "frame_p95_ms" not in line["metrics"]
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in line["metrics"]
    tail = err.strip().splitlines()[-len(line["compared"]):]
    for (name, v), text in zip(line["compared"].items(), tail):
        assert text.startswith(f"compared {name}: ")
        assert f"limit {v['limit']!r}" in text


def test_refuses_without_cards(monkeypatch, capsys):
    import torch

    from benchmark import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "serve_walk", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""
