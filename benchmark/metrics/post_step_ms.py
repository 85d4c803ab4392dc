"""Milliseconds a post-training step: the whole window over the steps
completed in it (host clock, the window ends in a device synchronise)."""


def read(view):
    res = view["res"]
    if not res.get("steps"):
        return None
    return 1000.0 * res["window_s"] / res["steps"]
