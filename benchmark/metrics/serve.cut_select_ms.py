"""Device milliseconds a frame inside the viewer's budget fit
(``HierarchyRenderer._fit_limit``) and cut selection
(``hierarchy/cut.expand_to_size``), from the window's trace."""


def read(view):
    tr = view.get("trace")
    if tr is None:
        return None
    frames = tr.range_count("bench.serve.render")
    selected = tr.range_count("bench.serve.expand")
    if not frames or not selected:
        return None
    s = tr.in_range_s("bench.serve.fit_limit") + tr.in_range_s(
        "bench.serve.expand")
    return 1000.0 * s / frames
