"""Host milliseconds a flat step that the loop spends preparing its next
view once decoded (``view.encode`` and ``view.copy`` in
``train/loop.BatchedPrefetcher``: uint8 encoding, pinning and the copy to
the card). ``wait_ms``: the milliseconds a step blocked on the decode
(``view.wait``); ``ready_share``: the share of views already decoded when
the loop asked (``view.ready``); ``p95_ms``: the 95th percentile over the
steps of the preparation (summed by each step's ordinal)."""

from collections import defaultdict

from _program import p95, record


def read(view):
    if view.get("trace") is None:
        return None
    rec = record()
    if rec is None:
        return None
    ms = {"view.next": 0.0, "view.wait": 0.0, "view.encode": 0.0,
          "view.copy": 0.0}
    per_step = defaultdict(float)
    steps = 0
    for name, _parent, t0, t1, ordinal in rec["spans"]:
        if name in ms and t1 is not None:
            ms[name] += (t1 - t0) * 1e-6
            steps += name == "view.next"
            if name in ("view.encode", "view.copy"):
                per_step[ordinal] += (t1 - t0) * 1e-6
    if not steps:
        return None
    ready = rec["counters"].get("view.ready")
    return {"value": (ms["view.encode"] + ms["view.copy"]) / steps,
            "wait_ms": ms["view.wait"] / steps,
            "ready_share": (ready["total"] / ready["samples"]
                            if ready else None),
            "p95_ms": p95(per_step.values())}
