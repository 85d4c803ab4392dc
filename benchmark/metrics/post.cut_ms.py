"""Device milliseconds a step inside cut selection and LOD interpolation
(``train/post_step.select_cut_gaussians``; its backward runs with the
step's gradients and is not in it), from the window's trace."""


def read(view):
    tr = view.get("trace")
    if tr is None:
        return None
    n = tr.range_count("bench.post.step")
    if not n or not tr.range_count("bench.post.cut"):
        return None
    return 1000.0 * tr.in_range_s("bench.post.cut") / n
