"""Share of the window's frames whose render reported ``cut_reused``
(the renderer's own stats, counted by the benchmark's wrapper)."""


def read(view):
    if view.get("trace") is None:
        return None
    res = view["res"]
    if not res.get("rendered"):
        return None
    return res["reused"] / res["rendered"]
