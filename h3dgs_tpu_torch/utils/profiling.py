"""Step timing and device profiling helpers (counterpart of
``h3dgs_tpu/utils/profiling.py``).

``StepTimer`` keeps an EMA of the wall-clock step time and the pixel
throughput. ``trace(log_dir)`` wraps a block with ``torch.profiler``
over the CPU and, when a card is present, its CUDA activity, and writes a
Chrome trace into ``log_dir`` (open it in Perfetto or chrome://tracing).
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


class StepTimer:
    """EMA over wall-clock step durations + pixel throughput."""

    def __init__(self, pixels_per_step: int = 0, ema: float = 0.9):
        self.pixels = pixels_per_step
        self.ema = ema
        self.avg_s = 0.0
        self._t0 = None
        self.n = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.avg_s = dt if self.n == 0 else \
            self.ema * self.avg_s + (1 - self.ema) * dt
        self.n += 1
        return dt

    @property
    def steps_per_s(self) -> float:
        return 1.0 / self.avg_s if self.avg_s else 0.0

    @property
    def mpix_per_s(self) -> float:
        return self.pixels * self.steps_per_s / 1e6

    def summary(self) -> str:
        s = f"{self.avg_s * 1e3:.1f} ms/it ({self.steps_per_s:.2f} it/s"
        if self.pixels:
            s += f", {self.mpix_per_s:.2f} Mpix/s"
        return s + ")"


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` around a block; yields the profiler (its
    ``key_averages()`` hold the block's operator and kernel times) and
    writes ``<log_dir>/trace.json`` when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
