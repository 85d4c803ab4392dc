"""The program-span helper (``metrics/_program.py``) on a synthetic trace
and record: the clock fit, the split of idle time and launches by
innermost span, and the refusals."""
from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np
import pytest

from _tiny import ROOT
from benchmark.core.trace import Trace

METRICS = os.path.join(ROOT, "benchmark", "metrics")
if METRICS not in sys.path:
    sys.path.insert(0, METRICS)
import _program  # noqa: E402

RATE, OFFSET = 1.0 + 3e-5, 8.5e11    # trace us = RATE * host us + OFFSET


def host_ns(trace_us):
    return int(round((trace_us - OFFSET) / RATE * 1e3))


def trace_of(ranges, ops=()):
    """A Trace of ``bench.*`` ranges {name: [(start, end)]} and device
    ops [(launch, start, duration)], times in trace microseconds."""
    ev = []
    for name, iv in ranges.items():
        for a, b in iv:
            ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                       "ts": a, "dur": b - a})
    for k, (launch, start, dur) in enumerate(ops):
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": launch, "dur": 1.0,
                   "args": {"correlation": k}})
        ev.append({"ph": "X", "cat": "kernel", "name": f"k{k}", "ts": start,
                   "dur": dur, "args": {"correlation": k}})
    return Trace(ev)


def record_of(spans, counters=None):
    """Program spans [(name, parent, start, end, ordinal)] given in trace
    microseconds, stamped on the host clock."""
    return {"spans": [(n, p, host_ns(a), host_ns(b), o)
                      for n, p, a, b, o in spans],
            "counters": counters or {}}


def steps(n, t0=0.0, period=1000.0):
    """``n`` flat steps: view.next, then train.step holding train.forward
    and train.update (with update.adam), each in its benchmark range."""
    spans, ranges = [], []
    for k in range(n):
        s = t0 + k * period
        base = len(spans)
        spans += [("view.next", -1, s, s + 100, k),
                  ("train.step", -1, s + 150, s + 900, k),
                  ("train.forward", base + 1, s + 200, s + 400, k),
                  ("train.update", base + 1, s + 600, s + 850, k),
                  ("update.adam", base + 3, s + 650, s + 800, k)]
        ranges.append((s + 148.5, s + 901.5))
    return spans, {"bench.train.step": ranges}


def test_fit_recovers_offset_and_rate():
    # 3000 steps over 30 s: at RATE 1 the spans drift 900 us off their
    # ranges, far beyond the 1.5 us of slack.
    spans, ranges = steps(3000, t0=1e6, period=1e4)
    win = _program.Window.fit(trace_of(ranges), record_of(spans))
    assert win is not None
    assert win.rate == pytest.approx(RATE, abs=2e-9)
    want = np.array([(a, b) for _, _, a, b, _ in spans])
    assert np.abs(win.t0 - want[:, 0]).max() < 1.0
    assert np.abs(win.t1 - want[:, 1]).max() < 1.0


def test_fit_refuses_spans_that_do_not_nest():
    spans, ranges = steps(50)
    a, b = ranges["bench.train.step"][20]
    ranges["bench.train.step"][20] = (a + 40.0, b)   # starts after its span
    assert _program.Window.fit(trace_of(ranges), record_of(spans)) is None
    spans, ranges = steps(50)
    ranges["bench.train.step"].pop()                 # a pair short
    assert _program.Window.fit(trace_of(ranges), record_of(spans)) is None


def test_gap_and_launches_land_on_the_innermost_span():
    spans, ranges = steps(2)
    # Busy [0, 500] and [700, 1500]: the gap [500, 700] finds the host in
    # train.step's own code until 600, then in train.update until 650,
    # then in update.adam. Launches: one in train.forward, two in
    # update.adam, one in train.update's own code.
    ops = [(300.0, 0.0, 500.0), (660.0, 700.0, 100.0),
           (700.0, 800.0, 50.0), (610.0, 850.0, 650.0)]
    win = _program.Window.fit(trace_of(ranges, ops), record_of(spans))
    idle = win.idle_by_span(-np.inf, np.inf)
    by = win.by_name(idle, np.ones(idle.shape, bool), 1.0)
    assert by == pytest.approx({"train.step": 100.0, "train.update": 50.0,
                                "update.adam": 50.0}, abs=0.5)
    us, n = win.device_by_span()
    got = win.by_name(n, np.ones(n.shape, bool), 1.0)
    assert got == {"train.forward": 1.0, "update.adam": 2.0,
                   "train.update": 1.0}
    upd = _program.device_in(win, "train.update", ("update.adam",))
    assert upd["value"] == pytest.approx((100 + 50 + 650) * 1e-3 / 2)
    assert upd["update.adam"] == pytest.approx(150 * 1e-3 / 2)


def _read(name, view):
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name, os.path.join(METRICS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(view)


def test_readers_on_a_synthetic_window(monkeypatch):
    """The flat step's readers: idle a step from one view.next to the
    next, split so that it sums; the update's device time; the counters."""
    from h3dgs_tpu_torch.utils import profiling

    spans, ranges = steps(3)
    spans += [("view.wait", 0, 10.0, 60.0, 0), ("view.encode", 0, 60.0,
                                                 80.0, 0)]
    spans.sort(key=lambda s: s[2])
    # Parents by index after the sort.
    fixed = []
    for name, _, a, b, o in spans:
        parent = -1
        for j in range(len(fixed) - 1, -1, -1):
            if fixed[j][2] <= a and b <= fixed[j][3]:
                parent = j
                break
        fixed.append((name, parent, a, b, o))
    ops = [(300.0, 0.0, 500.0), (660.0, 700.0, 1000.0),
           (1300.0, 1800.0, 400.0)]
    rec = record_of(fixed, {"train.alive_rows": [30, 2],
                            "train.capacity_rows": [120, 2],
                            "view.ready": [2, 3]})
    rec["counters"] = {k: {"total": v[0], "samples": v[1]}
                       for k, v in rec["counters"].items()}
    monkeypatch.setattr(profiling, "snapshot", lambda: rec)
    view = {"trace": trace_of(ranges, ops)}
    idle = _read("train.idle_by_span_ms", view)
    # Steps start at 0, 1000 and 2000: two whole steps, and in [0, 2000)
    # the card idles over [500, 700] and [1700, 1800].
    assert idle["units"] == 2
    assert idle["value"] == pytest.approx(0.15, abs=1e-3)
    assert sum(idle["by_span"].values()) == pytest.approx(idle["value"])
    # [500, 600] in train.step's own code, [600, 650] in train.update's,
    # [650, 700] and [1700, 1800] in update.adam.
    assert idle["by_span"] == pytest.approx(
        {"train.step": 0.05, "train.update": 0.025, "update.adam": 0.075},
        abs=1e-3)
    assert idle["outer_self_share"] == pytest.approx(1 / 3, abs=1e-2)
    assert _read("train.update_ms", view)["value"] == pytest.approx(
        1.0 / 3)
    assert _read("train.live_row_share", view) == {"value": 0.25,
                                                   "samples": 2}
    prep = _read("train.view_prepare_ms", view)
    assert prep["value"] == pytest.approx(0.02 / 3, rel=1e-3)
    assert prep["wait_ms"] == pytest.approx(0.05 / 3, rel=1e-3)
    assert prep["ready_share"] == pytest.approx(2 / 3)
    assert prep["p95_ms"] is None      # a tail needs 20 steps


def test_no_record_no_reading(monkeypatch):
    """A program that keeps no record (one that predates it) gives no
    reading, and raises nothing."""
    from h3dgs_tpu_torch.utils import profiling

    spans, ranges = steps(3)
    view = {"trace": trace_of(ranges)}
    monkeypatch.delattr(profiling, "snapshot")
    for name in ("train.idle_by_span_ms", "train.update_ms",
                 "train.live_row_share", "train.view_prepare_ms",
                 "serve.idle_by_span_ms", "serve.sync_ms",
                 "post.idle_by_span_ms", "post.launches_by_span",
                 "post.update_ms"):
        assert _read(name, view) is None


def test_serve_readers_by_ordinal(monkeypatch):
    """The serving readers sum each request's spans by its ordinal for a
    tail over frames, and set the layers' work counters beside the idle
    reading."""
    from h3dgs_tpu_torch.utils import profiling

    spans, ranges, ops = [], [], []
    for k in range(25):
        s = k * 1000.0
        base = len(spans)
        spans += [("serve.request", -1, s, s + 900, k),
                  ("serve.render", base, s + 100, s + 800, k),
                  ("serve.frame.sync", base + 1, s + 700, s + 710 + k, k)]
        ranges.append((s + 98.5, s + 801.5))
        ops.append((s + 150, s + 200, 300.0))
    rec = {"spans": [(n, p, host_ns(a), host_ns(b), o)
                     for n, p, a, b, o in spans],
           "counters": {"cut.rows": {"total": 300, "samples": 3},
                        "raster.entries": {"total": 2500, "samples": 25},
                        "view.ready": {"total": 1, "samples": 1}}}
    monkeypatch.setattr(profiling, "snapshot", lambda: rec)
    view = {"trace": trace_of({"bench.serve.render": ranges}, ops)}
    sync = _read("serve.sync_ms", view)
    assert sync["value"] == pytest.approx(0.022, abs=1e-4)
    assert sync["syncs_per_frame"] == 1.0
    assert sync["ms_by_site"] == pytest.approx({"serve.frame.sync": 0.022},
                                               abs=1e-4)
    # The 95th percentile of 10, 11, ..., 34 us (statistics.quantiles).
    assert sync["p95_ms"] == pytest.approx(0.0337, abs=1e-4)
    idle = _read("serve.idle_by_span_ms", view)
    # The card idles over the first 200 us of each request and from 500 us
    # to its end: not before its first op (request 0), nor after its last
    # (request 24).
    assert idle["value"] == pytest.approx((23 * 0.6 + 0.4 + 0.2) / 25,
                                          abs=1e-3)
    assert sum(idle["by_span"].values()) == pytest.approx(idle["value"])
    assert idle["p95_ms"] == pytest.approx(0.6, abs=1e-3)
    assert idle["work_per_call"] == {"cut.rows": 100.0,
                                     "raster.entries": 100.0}
    assert idle["pair_device_ms"] == pytest.approx(idle["bench_device_ms"])
    steps_spans, steps_ranges = steps(3)
    rec["spans"] = record_of(steps_spans)["spans"]
    view = {"trace": trace_of(steps_ranges)}
    assert _read("serve.sync_ms", view) is None
