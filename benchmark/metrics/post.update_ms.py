"""Device milliseconds a post step of the ops launched inside its update
(``post.update``: anchor and sky locking, dense Adam over every row)."""

from _program import device_in, window


def read(view):
    win = window(view)
    if win is None:
        return None
    return device_in(win, "post.update")
