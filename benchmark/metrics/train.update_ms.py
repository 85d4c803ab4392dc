"""Device milliseconds a flat step of the ops launched inside its update
(``train.update``: gradient locking, densification statistics, Adam and
the big-Gaussian shrink, over every capacity row), with each part's
(``lock``, ``stats``, ``adam``, ``shrink``)."""

from _program import device_in, window

PARTS = {"update.lock": "lock", "update.stats": "stats",
         "update.adam": "adam", "update.shrink": "shrink"}


def read(view):
    win = window(view)
    if win is None:
        return None
    got = device_in(win, "train.update", tuple(PARTS))
    if got is None:
        return None
    return {PARTS.get(k, k): v for k, v in got.items()}
