"""Tracing and timing on the card: a torch.profiler run into a directory,
named regions in its timeline, a step timer that synchronizes the device,
and the device's busy share and copy/compute overlap read from a trace."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, Optional, Tuple

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator["torch.profiler.profile"]:
    """A torch.profiler trace (CPU and, with a card, CUDA activity) of the
    region, the device synchronized at its end; yields the profiler, whose
    events() the caller may read. With log_dir it is also written there as
    trace.json, a Chrome trace (view at ui.perfetto.dev)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named region in the profiler's timeline."""
    return torch.profiler.record_function(name)


def _sync(device=None):
    if torch.cuda.is_available():
        torch.cuda.synchronize(device)


class StepTimer:
    """Wall-clock time of a step, the device synchronized before and after.

        timer = StepTimer()
        seconds = timer.time_fn(lambda: step(...), iters=10)  # per call
    """

    def __init__(self):
        self.history: List[float] = []

    def time_fn(self, fn, iters: int = 1) -> float:
        fn()
        _sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        _sync()
        dt = (time.perf_counter() - t0) / iters
        self.history.append(dt)
        return dt


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def busy_and_overlap(prof, wall_s: float) -> Tuple[float, float, float]:
    """(busy share, h2d copy ms, share of the copy time spent under a
    kernel) of a profiled window of wall_s seconds: busy share is the
    union of the kernels' intervals over the wall time."""
    kernels, h2d = [], []
    for e in prof.events():
        if e.device_type.name != "CUDA":
            continue
        span = (e.time_range.start, e.time_range.end)         # microseconds
        if e.name.startswith("Memcpy HtoD"):
            h2d.append(span)
        elif not e.name.startswith(("Memcpy", "Memset")):
            kernels.append(span)
    kernels, h2d = _union(kernels), _union(h2d)
    busy = _length(kernels) / (wall_s * 1e6)
    overlap = sum(max(0.0, min(b, kb) - max(a, ka)) for a, b in h2d for ka, kb in kernels)
    copy_us = _length(h2d)
    return busy, copy_us / 1e3, (overlap / copy_us if copy_us else 0.0)
