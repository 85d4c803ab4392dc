"""Share of the capacity rows that are alive, from the loop's counters
at its log points (``train.alive_rows`` over ``train.capacity_rows``,
where the loop already reads the live count): the part of the update's
rows that do work. ``samples``: the log points in the window."""

from _program import record


def read(view):
    if view.get("trace") is None:
        return None
    rec = record()
    if rec is None:
        return None
    alive = rec["counters"].get("train.alive_rows")
    cap = rec["counters"].get("train.capacity_rows")
    if not alive or not cap or not cap["total"]:
        return None
    return {"value": alive["total"] / cap["total"],
            "samples": alive["samples"]}
