"""The traced window: ``torch.profiler`` over CPU and CUDA, ranges of the
benchmark's own wrappers, and the reduction of the Chrome trace to what
the per-layer readers need.

Ranges are ``torch.profiler.record_function`` spans named ``bench.*``;
the device time inside a range is the time of the kernels, copies and
sets whose launch (correlated by the profiler's id) happened on the host
inside it. Busy time is the union of all device intervals.
"""
from __future__ import annotations

import collections
import json
import os

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Profiler:
    """Start and stop ``torch.profiler`` around the measured window."""

    def __init__(self, out_path: str):
        self.out_path = out_path
        self.prof = None

    def start(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()

    def stop(self) -> "Trace":
        self.prof.__exit__(None, None, None)
        self.prof.export_chrome_trace(self.out_path)
        self.prof = None
        try:
            return Trace.from_file(self.out_path)
        finally:
            os.remove(self.out_path)


class Trace:
    def __init__(self, events):
        dev, launches, ranges = [], {}, collections.defaultdict(list)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                dev.append((ts, dur, e.get("name", ""), corr))
            elif cat == "cuda_runtime" and corr is not None:
                launches[corr] = ts
            elif cat == "user_annotation" and str(
                    e.get("name", "")).startswith("bench."):
                ranges[e["name"]].append((ts, ts + dur))
        dev.sort()
        self.dev_ts = np.array([d[0] for d in dev], np.float64)
        self.dev_dur = np.array([d[1] for d in dev], np.float64)
        self.dev_name = [d[2] for d in dev]
        self.dev_launch = np.array(
            [launches.get(d[3], np.nan) for d in dev], np.float64)
        self.ranges = {k: np.array(sorted(v), np.float64).reshape(-1, 2)
                       for k, v in ranges.items()}

    @classmethod
    def from_file(cls, path: str) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data.get("traceEvents", data)
                   if isinstance(data, dict) else data)

    # --- device time ------------------------------------------------------
    def busy_s(self) -> float:
        if not self.dev_ts.size:
            return 0.0
        merged = self._merged()
        return float(sum(b - a for a, b in merged)) * 1e-6

    def _merged(self):
        out = []
        for a, d in zip(self.dev_ts, self.dev_dur):
            b = a + d
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def kernel_s(self, *substrings) -> float:
        """Seconds of device ops whose name holds any of ``substrings``."""
        return float(sum(d for d, n in zip(self.dev_dur, self.dev_name)
                         if any(s in n for s in substrings))) * 1e-6

    def n_device_ops(self) -> int:
        return len(self.dev_name)

    def _inside(self, name: str) -> np.ndarray:
        """Mask of the device ops launched inside the ranges ``name``."""
        inside = np.zeros(self.dev_ts.shape, bool)
        iv = self.ranges.get(name)
        if iv is None or not iv.size or not self.dev_ts.size:
            return inside
        k = np.searchsorted(iv[:, 0], self.dev_launch, side="right") - 1
        ok = (k >= 0) & ~np.isnan(self.dev_launch)
        inside[ok] = self.dev_launch[ok] <= iv[k[ok], 1]
        return inside

    def in_range_s(self, name: str) -> float:
        """Device seconds of ops launched inside the ranges ``name``."""
        return float(self.dev_dur[self._inside(name)].sum()) * 1e-6

    def kernel_in_range_s(self, name: str, *substrings) -> float:
        """Device seconds of the ops launched inside the ranges ``name``
        whose name holds any of ``substrings``."""
        hit = self._inside(name) & np.array(
            [any(s in n for s in substrings) for n in self.dev_name], bool)
        return float(self.dev_dur[hit].sum()) * 1e-6

    def range_count(self, name: str) -> int:
        iv = self.ranges.get(name)
        return 0 if iv is None else int(iv.shape[0])

    def range_host_s(self, name: str) -> float:
        iv = self.ranges.get(name)
        return 0.0 if iv is None else float((iv[:, 1] - iv[:, 0]).sum()) * 1e-6

    # --- breakdown --------------------------------------------------------
    def top_ops(self, n: int = 10):
        acc = collections.Counter()
        for d, name in zip(self.dev_dur, self.dev_name):
            acc[name[:96]] += d * 1e-6
        return [[k, v] for k, v in acc.most_common(n)]

    def idle_gaps(self, n: int = 10):
        """Idle device time between busy intervals, summed by the
        innermost ``bench.*`` range the host was in when the gap began."""
        merged = self._merged()
        spans = sorted((a, b, name) for name, iv in self.ranges.items()
                       for a, b in iv)
        acc = collections.Counter()
        active, j = [], 0
        for (_, end), (nxt, _) in zip(merged, merged[1:]):
            gap = nxt - end
            if gap <= 0:
                continue
            while j < len(spans) and spans[j][0] <= end:
                active.append(spans[j])
                j += 1
            active = [s for s in active if s[1] >= end]
            inner = min(active, key=lambda s: s[1] - s[0])[2] \
                if active else "outside any range"
            acc[inner] += gap * 1e-6
        return [[k, v] for k, v in acc.most_common(n)]
