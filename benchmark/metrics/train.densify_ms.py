"""Device milliseconds of a densify pass in the window
(``train/step.densify_step``: clone, split and prune over the capacity
rows), from the trace's ``bench.train.densify`` ranges. The window holds
one pass, where a run holds one every 300 steps: this reads the pass
apart from the steps it is averaged into."""


def read(view):
    tr = view.get("trace")
    if tr is None:
        return None
    n = tr.range_count("bench.train.densify")
    s = tr.in_range_s("bench.train.densify")
    if not n or s <= 0:
        return None
    return 1000.0 * s / n
