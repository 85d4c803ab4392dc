"""Device idle milliseconds a frame inside the viewer's requests
(``serve.request`` in ``viewer/service.serve``: read, render, send), each
idle instant given to the innermost program span the host was in then
(``by_span``, which sums to the value). ``outer_self_share`` is the part
in the self time of ``serve.request`` and ``serve.render``; the program's
device time inside ``serve.render`` stands beside the benchmark range's
(``pair_device_ms``, ``bench_device_ms``)."""

from _program import idle_in, window


def read(view):
    win = window(view)
    if win is None:
        return None
    return idle_in(win, ("serve.request", "serve.render"), "serve.render")
