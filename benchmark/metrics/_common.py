"""Helpers the metric readers share. Each reader is ``read(view)``:
``view`` holds the cell's name, the driver's result (``res``), the
reference check with its work counts (``check``), the window's trace
(``trace``, None in an untraced run), ``setup_s`` and the card's
``power_limit_w``. A reader returns a number, a dict with ``value`` and
further keys, or None when it finds nothing to read."""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark.work import peaks  # noqa: E402


def mean(xs):
    xs = list(xs)
    return sum(xs) / len(xs) if xs else None


def roofline(view, ops: float, nbytes: float, seconds: float):
    """Share (%) of the published peak that the counted least time is of
    the measured time, naming the bound and the card's power limit."""
    if not seconds or seconds <= 0:
        return None
    least, bound = peaks.least_time(ops, nbytes)
    return {"value": 100.0 * least / seconds, "bound": bound,
            "power_limit_w": view.get("power_limit_w")}


def idle(view):
    """Share (%) of the traced window with no device op running."""
    tr, span = view.get("trace"), view.get("traced_s")
    if tr is None or not span:
        return None
    return 100.0 * max(0.0, 1.0 - tr.busy_s() / span)
