"""Device profiling and the program's own spans and counters
(counterpart of ``h3dgs_tpu/utils/profiling.py``).

``trace(log_dir)`` wraps a block with ``torch.profiler`` over the CPU and,
when a card is present, its CUDA activity, and writes a Chrome trace into
``log_dir`` (open it in Perfetto or chrome://tracing).

``span(name)`` and ``count(name, value)`` mark the program's layers where
the work happens. They record only while a torch profiler is recording
on the calling thread (``trace`` here, or any ``torch.profiler.profile``),
so no flag turns them on. Then a span is a ``record_function`` range
``h3dgs.<name>`` in the profiler's trace, on the kernels' clock, and one
record in memory: its name, its parent, its start and end in
``time.perf_counter_ns`` and the ordinal of the frame or step it belongs
to. A counter adds a value the program already holds on the host to a
per-name total. Off, ``span`` returns one shared no-op context and
``count`` returns at once: neither allocates nor touches the device.

``snapshot()`` returns the record of one continuous recorded stretch: a
span or counter made with recording off ends the stretch, and the next
one made with recording on starts a new record. Spans belong on the
thread that runs the frame or the step: a profiler records each thread's
ranges apart, and the record is one list.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

_recording = torch.autograd._profiler_enabled
_clock = time.perf_counter_ns


class _Record:
    """One recorded stretch: spans as [name, parent, start ns, end ns,
    ordinal] in the order they opened, counters as [total, samples]."""

    def __init__(self):
        self.spans = []
        self.counters = {}
        self.stack = []
        self.ordinal = -1
        self.ended = False


_rec = _Record()


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("rec", "name", "begins", "row", "range")

    def __init__(self, rec: _Record, name: str, begins: bool):
        self.rec, self.name, self.begins = rec, name, begins

    def __enter__(self):
        rec = self.rec
        if self.begins and not rec.stack:
            rec.ordinal += 1
        self.row = [self.name, rec.stack[-1] if rec.stack else -1,
                    _clock(), None, rec.ordinal]
        rec.stack.append(len(rec.spans))
        rec.spans.append(self.row)
        self.range = torch.profiler.record_function("h3dgs." + self.name)
        self.range.__enter__()
        return None

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        self.row[3] = _clock()
        self.rec.stack.pop()
        return False


def _current() -> _Record:
    """The record to write into while recording is on."""
    global _rec
    if _rec.ended:
        _rec = _Record()
    return _rec


def span(name: str, begins: bool = False):
    """A context that records the span ``name`` while a profiler records
    on this thread. ``begins``: the span opens a new frame or step (its
    ordinal) when no other span is open."""
    if not _recording():
        _rec.ended = True
        return _NULL
    return _Span(_current(), name, begins)


def count(name: str, value) -> None:
    """Add ``value`` (a host number) to the counter ``name`` while a
    profiler records on this thread."""
    if not _recording():
        _rec.ended = True
        return
    counters = _current().counters
    c = counters.get(name)
    if c is None:
        counters[name] = [value, 1]
    else:
        c[0] += value
        c[1] += 1


def snapshot() -> dict:
    """The last recorded stretch as plain Python: ``spans``, a list of
    (name, parent index or -1, start ns, end ns or None while open,
    ordinal), and ``counters``, name -> {"total", "samples"}."""
    return {"spans": [tuple(s) for s in _rec.spans],
            "counters": {k: {"total": v[0], "samples": v[1]}
                         for k, v in _rec.counters.items()}}


def reset() -> None:
    """Forget the record: the next recorded span or counter starts anew."""
    global _rec
    _rec = _Record()


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` around a block; yields the profiler (its
    ``key_averages()`` hold the block's operator and kernel times) and
    writes ``<log_dir>/trace.json`` when the block ends. The program's
    spans and counters of the block are ``snapshot()`` afterwards."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
