"""The program's own spans and counters (``h3dgs_tpu_torch.utils.profiling``)
placed on the traced window's clock, and the reductions the per-layer
readers of them share.

The window's ``Trace`` keeps the benchmark's ``bench.*`` ranges; the
program stamps its spans with the host's monotonic clock
(``time.perf_counter_ns``), the profiler with its own. ``window(view)``
maps the one onto the other by pairs: a program span and the benchmark
range that wraps the same call one to one (``PAIRS``). Each pair bounds
the mapping from both sides, since the range starts before its span and
ends after it. The fit takes the rate (within ``MAX_SKEW`` of 1; 1 itself
when it leaves room) that leaves the most room, and the offset in the
middle of what every pair allows. It gives None, and so no reading, when
some pair's span cannot lie inside its range within ``TOL_US``, when the
pairs differ in number, or when the program keeps no record (one that
predates it).

Reductions over the mapped spans: a device op belongs to the innermost
span open when the host launched it (the rule of ``Trace._inside``); an
idle instant of the card (between its merged busy intervals, as
``Trace.idle_gaps`` takes them) belongs to the innermost span the host was
in at that instant, so a gap the host crosses several spans in is split
between them; a span's self time is its time less what its children
cover. A span's ordinal names the frame or step it belongs to, so a
quantity summed by ordinal has a tail over frames or steps (``p95``).
The layers' work counters (``WORK``) stand beside the idle readings as
their mean a call.
"""
from __future__ import annotations

import statistics

import numpy as np

PAIRS = (("serve.render", "bench.serve.render"),
         ("train.step", "bench.train.step"),
         ("post.step", "bench.post.step"))
TOL_US = 2.0
MAX_SKEW = 1e-3
OUTSIDE = "outside any span"
WORK = ("cut.rows", "raster.entries")


def record():
    """The program's record of the last recorded stretch, or None."""
    try:
        from h3dgs_tpu_torch.utils import profiling
    except ImportError:
        return None
    snap = getattr(profiling, "snapshot", None)
    if snap is None:
        return None
    rec = snap()
    return rec if rec.get("spans") else None


def p95(values):
    """95th percentile (``statistics.quantiles``), or None under 20."""
    values = list(values)
    if len(values) < 20:
        return None
    return statistics.quantiles(values, n=20)[-1]


def window(view):
    """The traced window's program spans on the trace's clock, or None."""
    tr = view.get("trace")
    if tr is None:
        return None
    rec = record()
    if rec is None:
        return None
    return Window.fit(tr, rec)


def fit_clock(host, ranges):
    """(rate, offset) mapping host microseconds ``host`` ([n, 2] span
    starts and ends) into ``ranges`` ([n, 2], the enclosing ranges on the
    trace's clock) so that each span lies inside its range, or None when
    none does within ``TOL_US``. Times are taken relative to the first
    pair's."""
    a, b = host[:, 0], host[:, 1]
    lo, hi = ranges[:, 0], ranges[:, 1]

    def room(r):
        low = np.max(lo - r * a)
        return np.min(hi - r * b) - low, low

    best = 1.0
    if room(1.0)[0] < 0:
        x, y = 1.0 - MAX_SKEW, 1.0 + MAX_SKEW
        for _ in range(200):
            m1, m2 = x + (y - x) / 3, y - (y - x) / 3
            if room(m1)[0] < room(m2)[0]:
                x = m1
            else:
                y = m2
        best = (x + y) / 2
    width, low = room(best)
    if width < -2 * TOL_US:
        return None
    return best, low + width / 2


class Window:
    """The spans of the window, mapped, with their tree and counters."""

    def __init__(self, trace, rec, rate, offset, base):
        spans = rec["spans"]
        self.trace = trace
        self.counters = rec.get("counters", {})
        self.names = [s[0] for s in spans]
        self.parent = np.array([s[1] for s in spans], np.int64)
        self.ordinal = np.array([s[4] for s in spans], np.int64)
        start = np.array([s[2] for s in spans], np.float64)
        end = np.array([s[2] if s[3] is None else s[3] for s in spans],
                       np.float64)
        self.t0 = rate * (start / 1e3 - base) + offset
        self.t1 = rate * (end / 1e3 - base) + offset
        self.rate = rate

    @classmethod
    def fit(cls, trace, rec):
        spans = rec["spans"]
        host, ranges = [], []
        for name, rng in PAIRS:
            mine = [s for s in spans if s[0] == name and s[3] is not None]
            theirs = trace.ranges.get(rng)
            n = 0 if theirs is None else theirs.shape[0]
            if len(mine) != n:
                return None
            host += [(s[2], s[3]) for s in mine]
            if n:
                ranges.append(theirs)
        if not host:
            return None
        host = np.array(host, np.float64) / 1e3
        base = host[0, 0]
        ranges = np.concatenate(ranges)
        got = fit_clock(host - base, ranges)
        if got is None:
            return None
        return cls(trace, rec, got[0], got[1], base)

    # --- the tree ---------------------------------------------------------
    def named(self, name: str) -> np.ndarray:
        return np.array([i for i, n in enumerate(self.names) if n == name],
                        np.int64)

    def under(self, names) -> np.ndarray:
        """Per span, the index of its nearest ancestor (itself included)
        whose name is in ``names``, else -1. Parents precede children."""
        names = set(names)
        out = np.full(len(self.names), -1, np.int64)
        for i, n in enumerate(self.names):
            if n in names:
                out[i] = i
            elif self.parent[i] >= 0:
                out[i] = out[self.parent[i]]
        return out

    def innermost(self, t: np.ndarray) -> np.ndarray:
        """Index of the innermost span open at each time ``t``, else -1."""
        k = np.searchsorted(self.t0, t, side="right") - 1
        for _ in range(64):
            out = (k >= 0)
            out[out] = self.t1[k[out]] < t[out]
            if not out.any():
                break
            k[out] = self.parent[k[out]]
        return k

    def name_of(self, idx) -> str:
        return OUTSIDE if idx < 0 else self.names[idx]

    # --- reductions -------------------------------------------------------
    def device_by_span(self):
        """(device us, device ops) per span (index -1: launched outside
        every span, or launch unknown)."""
        tr = self.trace
        n = len(self.names)
        k = np.full(tr.dev_ts.shape, -1, np.int64)
        ok = ~np.isnan(tr.dev_launch)
        k[ok] = self.innermost(tr.dev_launch[ok])
        us = np.bincount(k + 1, weights=tr.dev_dur, minlength=n + 1)
        ops = np.bincount(k + 1, minlength=n + 1)
        return us, ops

    def idle_by_span(self, lo: float, hi: float):
        """Idle us of the card within [lo, hi) per innermost host span
        (position 0: outside every span; span i at i + 1)."""
        tr = self.trace
        n = len(self.names)
        out = np.zeros(n + 1)
        if tr.dev_ts.size < 2 or hi <= lo:
            return out
        busy = np.array(tr._merged(), np.float64)
        lo, hi = max(lo, busy[0, 0]), min(hi, busy[-1, 1])
        g0, g1 = busy[:-1, 1], busy[1:, 0]
        keep = g1 > g0
        g0, g1 = np.clip(g0[keep], lo, hi), np.clip(g1[keep], lo, hi)
        keep = g1 > g0
        g0, g1 = g0[keep], g1[keep]
        if not g0.size:
            return out
        cum = np.concatenate([[0.0], np.cumsum(g1 - g0)])

        def idle_before(t):
            # Whole gaps before the last one that starts at or before t,
            # and the part of that one before t.
            j = np.searchsorted(g0, t, side="right")
            last = np.maximum(j - 1, 0)
            part = np.clip(t - g0[last], 0.0, g1[last] - g0[last])
            return np.where(j > 0, cum[last] + part, 0.0)

        cuts = np.unique(np.concatenate([[lo, hi], self.t0, self.t1]))
        cuts = cuts[(cuts >= lo) & (cuts <= hi)]
        a, b = cuts[:-1], cuts[1:]
        idle = idle_before(b) - idle_before(a)
        k = self.innermost((a + b) / 2)
        np.add.at(out, k + 1, idle)
        return out

    def self_us(self) -> np.ndarray:
        """Host self time per span: its time less its children's."""
        dur = self.t1 - self.t0
        own = dur.copy()
        has = self.parent >= 0
        np.subtract.at(own, self.parent[has], dur[has])
        return own

    # --- per unit ---------------------------------------------------------
    def by_ordinal(self, values: np.ndarray, pick) -> np.ndarray:
        """``values`` (per span, position 0 outside) summed by the
        ordinal of the spans where ``pick`` holds: one sum a frame or
        step (spans before the first have no ordinal and are left out)."""
        pos = np.nonzero(pick)[0]
        pos = pos[pos > 0]
        ords = self.ordinal[pos - 1]
        keep = ords >= 0
        if not keep.any():
            return np.zeros(0)
        ords = ords[keep]
        sums = np.bincount(ords, weights=values[pos[keep]])
        return sums[np.unique(ords)]

    def work(self) -> dict:
        """Mean a call of each layer's work counter in the record."""
        return {k: c["total"] / c["samples"] for k, c in self.counters.items()
                if k in WORK and c["samples"]}

    def by_name(self, values: np.ndarray, pick, scale: float) -> dict:
        """``values`` (per span, position 0 outside) summed by name over
        the positions where ``pick`` holds, times ``scale``."""
        out = {}
        for pos in np.nonzero(pick)[0]:
            v = float(values[pos])
            if v:
                name = self.name_of(pos - 1)
                out[name] = out.get(name, 0.0) + v * scale
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def idle_in(win: Window, outer: tuple, pair: str) -> dict:
    """Device idle ms a unit inside the spans ``outer`` (and their
    children), split by innermost span; a unit is one span ``outer[0]``.
    ``pair`` names the span whose device time is set beside its
    benchmark range's (``nesting``)."""
    n = len(win.named(outer[0]))
    if not n:
        return None
    idle = win.idle_by_span(-np.inf, np.inf)
    pick = np.concatenate([[False], win.under(outer) >= 0])
    out = _idle_line(win, idle, pick, outer, n, pair)
    out["p95_ms"] = p95(win.by_ordinal(idle, pick) * 1e-3)
    return out


def idle_steps(win: Window, begins: str, outer: tuple) -> dict:
    """Device idle ms a step, a step running from the start of one span
    ``begins`` to the start of the next, split by innermost span (the
    loop's own code between spans is ``OUTSIDE``)."""
    starts = win.t0[win.named(begins)]
    if starts.size < 2:
        return None
    idle = win.idle_by_span(starts[0], starts[-1])
    pick = np.ones(idle.shape, bool)
    hosts = np.concatenate([[False], (win.t0 >= starts[0])
                            & (win.t0 < starts[-1])])
    return _idle_line(win, idle, pick, outer, starts.size - 1, outer[0],
                      hosts)


def _idle_line(win, idle, pick, outer, n, pair, hosts=None):
    """The reading: idle ms a unit, its split by innermost span (which
    sums to it), the share in the self time of the ``outer`` spans, the
    host's self ms a unit by span, the layers' work a call, and the
    pair's device time against its range's."""
    scale = 1e-3 / n
    own = np.concatenate([[False], np.isin(np.array(win.names, object),
                                           outer)])
    total = float(idle[pick].sum()) * scale
    out = {"value": total, "units": n,
           "by_span": win.by_name(idle, pick, scale),
           "outer_self_share": (float(idle[pick & own].sum()) * scale
                                / total if total else 0.0),
           "host_self_ms": win.by_name(
               np.concatenate([[0.0], win.self_us()]),
               pick if hosts is None else hosts, scale),
           "work_per_call": win.work()}
    out.update(nesting(win, pair))
    return out


def nesting(win: Window, name: str) -> dict:
    """The device ms a unit of the ops launched inside the spans ``name``
    by the program's spans and by the benchmark's enclosing range."""
    rng = dict(PAIRS).get(name)
    idx = win.named(name)
    if rng is None or not idx.size:
        return {}
    us, _ = win.device_by_span()
    top = win.under([name])
    mine = float(us[1:][top >= 0].sum())
    theirs = win.trace.in_range_s(rng) * 1e6
    return {"pair": [name, rng],
            "pair_device_ms": mine * 1e-3 / idx.size,
            "bench_device_ms": theirs * 1e-3 / idx.size}


def device_in(win: Window, name: str, children=()):
    """Device ms a span ``name`` of the ops launched inside it, and of
    those inside each of its ``children``."""
    idx = win.named(name)
    if not idx.size:
        return None
    us, _ = win.device_by_span()
    top = win.under([name])
    out = {"value": float(us[1:][top >= 0].sum()) * 1e-3 / idx.size}
    for child in children:
        sub = win.under([child])
        out[child] = float(us[1:][(sub >= 0) & (top >= 0)].sum()) \
            * 1e-3 / idx.size
    return out
