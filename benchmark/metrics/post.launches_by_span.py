"""Device operations (kernels, copies, sets) a post step launches inside
``post.step``, with the launches a step by the innermost program span the
host launched them from (``by_span``, which sums to the value): where the
host's launch rate goes."""

import numpy as np

from _program import window


def read(view):
    win = window(view)
    if win is None:
        return None
    n = win.named("post.step").size
    if not n:
        return None
    _, ops = win.device_by_span()
    pick = np.concatenate([[False], win.under(("post.step",)) >= 0])
    return {"value": float(ops[pick].sum()) / n,
            "by_span": win.by_name(ops, pick, 1.0 / n)}
