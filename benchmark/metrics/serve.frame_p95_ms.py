"""95th percentile of every frame request in the traced window, from its
send to the last byte of its reply at the client (client's clock). The
tail of a cell whose host-clock tail swings too widely from run to run
to hold a bound end to end; read under the profiler."""

import statistics


def read(view):
    lat = view["res"].get("latency_s")
    if view.get("trace") is None or not lat or len(lat) < 20:
        return None
    return 1000.0 * statistics.quantiles(lat, n=20)[-1]
