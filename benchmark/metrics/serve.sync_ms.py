"""Host milliseconds a frame in the spans whose name ends in ``.sync``:
the host reads of device values on the frame path (the camera centre, the
cut's size, the entry and tile counts of binning, the budget fit's
hysteresis flag, the reuse distance and limit, the frame's copy).
Further keys: the reads a frame, the milliseconds a frame by site, and
the 95th percentile over the frames (each request's reads summed by its
ordinal)."""

import numpy as np

from _program import p95, window


def read(view):
    win = window(view)
    if win is None:
        return None
    frames = win.named("serve.render").size
    if not frames:
        return None
    inside = win.under(("serve.request", "serve.render")) >= 0
    sync = np.array([n.endswith(".sync") for n in win.names], bool)
    pick = np.concatenate([[False], inside & sync])
    us = np.concatenate([[0.0], win.t1 - win.t0])
    return {"value": float(us[pick].sum()) * 1e-3 / frames,
            "syncs_per_frame": int(pick.sum()) / frames,
            "ms_by_site": win.by_name(us, pick, 1e-3 / frames),
            "p95_ms": p95(win.by_ordinal(us, pick) * 1e-3)}
