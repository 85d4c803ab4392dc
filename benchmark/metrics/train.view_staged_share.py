"""Share of the flat loop's views that arrived staged from the decode
pool (``view.staged`` in ``train/loop.BatchedPrefetcher``: 1 for a view
the stream's workers encoded into one record, 0 for one the loop encoded
and moved itself), over the traced window. ``views``: the views counted.
A program that counts no staged views gives no reading."""

from _program import record


def read(view):
    if view.get("trace") is None:
        return None
    rec = record()
    if rec is None:
        return None
    staged = rec["counters"].get("view.staged")
    if not staged or not staged["samples"]:
        return None
    return {"value": staged["total"] / staged["samples"],
            "views": staged["samples"]}
