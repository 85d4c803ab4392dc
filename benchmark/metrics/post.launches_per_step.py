"""Device operations (kernels, copies, sets) a post step launches, from
the window's trace: the host's launch rate is what holds this step."""


def read(view):
    tr = view.get("trace")
    if tr is None:
        return None
    n = tr.range_count("bench.post.step")
    if not n:
        return None
    return tr.n_device_ops() / n
