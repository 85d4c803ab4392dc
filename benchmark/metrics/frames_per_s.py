"""Frames the viewer received over the window (client's clock)."""


def read(view):
    res = view["res"]
    if not res.get("latency_s"):
        return None
    return len(res["latency_s"]) / res["window_s"]
