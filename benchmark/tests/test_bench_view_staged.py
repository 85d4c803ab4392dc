"""The reader of ``train.view_staged_share`` on a synthetic record: the
share of views that arrived staged, a zero share when none did, and no
reading when the program counts no staged views."""
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


@pytest.mark.parametrize("total, share", [(250, 1.0), (200, 0.8),
                                          (0, 0.0)])
def test_view_staged_share(monkeypatch, total, share):
    """250 views counted: every one staged, 200 of them, and none (each
    view took the loop's own encode and copy)."""
    view = _view_with(monkeypatch, {"view.staged": [total, 250],
                                    "view.ready": [250, 250]})
    got = _read("train.view_staged_share", view)
    assert got["value"] == pytest.approx(share)
    assert got["views"] == 250


def test_view_staged_share_without_counter(monkeypatch):
    """A program that predates the counter gives no reading, and raises
    nothing; nor does an untraced run."""
    view = _view_with(monkeypatch, {"view.ready": [250, 250]})
    assert _read("train.view_staged_share", view) is None
    assert _read("train.view_staged_share", {"trace": None}) is None
