"""Observe the program from outside: wrap module or class attributes so
that each call runs inside a ``torch.profiler.record_function`` range
named ``bench.<name>`` (and, optionally, hands its result to a hook),
and put every attribute back afterwards."""
from __future__ import annotations

import functools


class StopWindow(Exception):
    """Raised from a training loop's step callback when the window has
    closed; the drivers catch it around the loop."""


def ranged_factory(factory, name: str):
    """``factory`` (a builder of step functions), whose built functions
    run inside the range ``bench.<name>``."""
    import torch

    @functools.wraps(factory)
    def make(*args, **kwargs):
        fn = factory(*args, **kwargs)

        @functools.wraps(fn)
        def ranged(*a, **k):
            with torch.profiler.record_function(f"bench.{name}"):
                return fn(*a, **k)
        return ranged
    return make


class Patches:
    """Attribute replacements, undone in reverse order by ``undo``."""

    def __init__(self):
        self._saved = []

    def set(self, owner, attr: str, value):
        self._saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    def ranged(self, owner, attr: str, name: str, hook=None):
        """Run ``owner.attr`` inside the range ``bench.<name>``; ``hook``
        (if given) sees (args, kwargs, result) and returns the result."""
        import torch
        orig = getattr(owner, attr)
        label = f"bench.{name}"

        @functools.wraps(orig)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(label):
                out = orig(*args, **kwargs)
            return hook(args, kwargs, out) if hook is not None else out

        self.set(owner, attr, wrapped)
        return orig

    def undo(self):
        while self._saved:
            owner, attr, value = self._saved.pop()
            setattr(owner, attr, value)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.undo()
