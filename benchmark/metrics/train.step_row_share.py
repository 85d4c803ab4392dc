"""Share of the capacity rows the flat step runs on, from the loop's
counters at its log points (``train.step_rows``, the store's high-water
mark, over ``train.capacity_rows``). ``live_of_step``: the live rows'
share of the step's rows (``train.alive_rows`` over
``train.step_rows``). ``samples``: the log points in the window. A
program that counts no step rows gives no reading."""

from _program import record


def read(view):
    if view.get("trace") is None:
        return None
    rec = record()
    if rec is None:
        return None
    counters = rec["counters"]
    rows = counters.get("train.step_rows")
    cap = counters.get("train.capacity_rows")
    alive = counters.get("train.alive_rows")
    if not rows or not cap or not alive or not cap["total"] \
            or not rows["total"]:
        return None
    return {"value": rows["total"] / cap["total"],
            "live_of_step": alive["total"] / rows["total"],
            "samples": rows["samples"]}
