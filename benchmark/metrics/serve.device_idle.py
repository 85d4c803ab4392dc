"""Share (%) of the traced window in which no kernel, copy or set ran on
the card."""

from _common import idle


def read(view):
    return idle(view)
