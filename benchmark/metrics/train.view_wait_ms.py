"""Host milliseconds a step that the loop spends getting its next view
from the stream (``train/loop.BatchedPrefetcher.__next__``: waiting for a
decoded view and starting its copy to the card), from the trace's
ranges."""


def read(view):
    tr = view.get("trace")
    if tr is None:
        return None
    n = tr.range_count("bench.train.view_next")
    if not n:
        return None
    return 1000.0 * tr.range_host_s("bench.train.view_next") / n
