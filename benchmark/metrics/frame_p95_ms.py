"""95th percentile of every frame request in the window, from its send
to the last byte of its reply at the client (client's clock)."""

import statistics


def read(view):
    lat = view["res"].get("latency_s")
    if not lat or len(lat) < 20:
        return None
    return 1000.0 * statistics.quantiles(lat, n=20)[-1]
