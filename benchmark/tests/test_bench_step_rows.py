"""The reader of ``train.step_row_share`` on a synthetic record: the
rows the flat step ran on over the capacity rows, the live rows' share
of them, and no reading when the program counts no step rows."""
from __future__ import annotations

import pytest

from test_bench_program import _read, record_of, steps, trace_of


def _view_with(monkeypatch, counters):
    from h3dgs_tpu_torch.utils import profiling

    spans, ranges = steps(3)
    rec = record_of(spans)
    rec["counters"] = {k: {"total": v[0], "samples": v[1]}
                       for k, v in counters.items()}
    monkeypatch.setattr(profiling, "snapshot", lambda: rec)
    return {"trace": trace_of(ranges)}


def test_step_row_share(monkeypatch):
    """Two log points: 1,280 and 1,344 step rows of 8,192 capacity rows,
    1,100 and 1,200 of them alive."""
    view = _view_with(monkeypatch, {"train.alive_rows": [2300, 2],
                                    "train.capacity_rows": [16384, 2],
                                    "train.step_rows": [2624, 2]})
    got = _read("train.step_row_share", view)
    assert got["value"] == pytest.approx(2624 / 16384)
    assert got["live_of_step"] == pytest.approx(2300 / 2624)
    assert got["samples"] == 2


@pytest.mark.parametrize("missing", ["train.step_rows",
                                     "train.capacity_rows",
                                     "train.alive_rows"])
def test_step_row_share_missing_counter(monkeypatch, missing):
    """A program that lacks one of the three counters (one that predates
    the step rows' counter) gives no reading, and raises nothing."""
    counters = {"train.alive_rows": [2300, 2],
                "train.capacity_rows": [16384, 2],
                "train.step_rows": [2624, 2]}
    del counters[missing]
    view = _view_with(monkeypatch, counters)
    assert _read("train.step_row_share", view) is None
    assert _read("train.step_row_share", {"trace": None}) is None
