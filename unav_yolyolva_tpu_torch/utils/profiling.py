"""Tracing and timing on the card: the program's spans, a torch.profiler
run into a directory, a step timer that synchronizes the device, and the
device's busy share and copy/compute overlap read from a trace.

Spans. `span(name)` marks a region of the program, named
`unav.<area>.<name>`: the train and eval steps and their phases, the
model's layers and the kernel wrappers' entry points (`spanned`). With no
recorder enabled and the profiler not running it returns one shared no-op
context manager, after two flag reads and nothing else. While torch.profiler runs,
the span is also a `record_function`, so that it lands in the trace beside
the kernels it launched. Under `record_spans()` each span appends
[name, parent, t0_ns, t1_ns] (time.perf_counter_ns; the parent is the
enclosing span of the same thread, or None) to the recorder's list in
memory, and `summary()` gives each name's count, total and self time:

    with record_spans() as rec:
        step(state, batch)
    rec.summary()["unav.train.backward"]   # {"count", "total_ns", "self_ns"}
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler


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


class _Off:
    """The span of a run that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_recorder: Optional["SpanRecorder"] = None


class _Span:
    __slots__ = ("name", "rf", "entry", "rec")

    def __init__(self, name: str, rec: Optional["SpanRecorder"]):
        self.name, self.rec, self.rf, self.entry = name, rec, None, None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        if self.rec is not None:
            self.entry = self.rec._open(self.name)
        return self

    def __exit__(self, *exc):
        if self.entry is not None:
            self.rec._close(self.entry)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A named region of the program (see the module's docstring)."""
    rec = _recorder
    if rec is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, rec)


def spanned(name: str):
    """A decorator: every call of the function runs inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class SpanRecorder:
    """The spans of a `record_spans()` region, in memory. `entries` holds
    [name, parent entry or None, t0_ns, t1_ns] in the order the spans
    opened; a span still open has t1_ns None."""

    def __init__(self):
        self.entries: List[list] = []
        self.clock = time.perf_counter_ns
        self._open_here = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._open_here, "stack", None)
        if stack is None:
            stack = self._open_here.stack = []
        return stack

    def _open(self, name: str) -> list:
        stack = self._stack()
        entry = [name, stack[-1] if stack else None, self.clock(), None]
        self.entries.append(entry)
        stack.append(entry)
        return entry

    def _close(self, entry: list) -> None:
        entry[3] = self.clock()
        self._stack().pop()

    def spans(self) -> List[Tuple[str, Optional[str], int, int]]:
        """(name, parent's name or None, t0_ns, t1_ns) of every closed span."""
        return [(n, p[0] if p is not None else None, t0, t1)
                for n, p, t0, t1 in self.entries if t1 is not None]

    def summary(self) -> Dict[str, Dict[str, int]]:
        """{name: {count, total_ns, self_ns}} of the closed spans: self time
        is a span's duration less the time its child spans cover."""
        out: Dict[str, Dict[str, int]] = {}
        children: Dict[int, List[Tuple[int, int]]] = {}
        for _, parent, t0, t1 in self.entries:
            if parent is not None and t1 is not None:
                children.setdefault(id(parent), []).append((t0, t1))
        for entry in self.entries:
            name, _, t0, t1 = entry
            if t1 is None:
                continue
            covered = _length(_union([(max(a, t0), min(b, t1))
                                      for a, b in children.get(id(entry), [])
                                      if min(b, t1) > max(a, t0)]))
            s = out.setdefault(name, {"count": 0, "total_ns": 0, "self_ns": 0})
            s["count"] += 1
            s["total_ns"] += t1 - t0
            s["self_ns"] += t1 - t0 - covered
        return out


@contextlib.contextmanager
def record_spans() -> Iterator[SpanRecorder]:
    """Record every span of the program, on every thread, while the region
    runs; yields the recorder."""
    global _recorder
    rec, outer = SpanRecorder(), _recorder
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = outer


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


def is_kernel(e) -> bool:
    """A profiler event or key_averages() row of a kernel on the card: not a
    copy, a memset or a span's annotation on the device's timeline."""
    name = getattr(e, "key", None) or e.name
    return e.device_type.name == "CUDA" and not name.startswith(("Memcpy", "Memset", "unav."))


def busy_and_overlap(prof, wall_s: float) -> Tuple[float, float, float]:
    """(busy share, h2d copy ms, share of the copy time spent under a
    kernel) of a profiled window of wall_s seconds: busy share is the
    union of the kernels' intervals over the wall time."""
    kernels, h2d = [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end)         # microseconds
        if e.device_type.name == "CUDA" and e.name.startswith("Memcpy HtoD"):
            h2d.append(span)
        elif is_kernel(e):
            kernels.append(span)
    kernels, h2d = _union(kernels), _union(h2d)
    busy = _length(kernels) / (wall_s * 1e6)
    overlap = sum(max(0.0, min(b, kb) - max(a, ka)) for a, b in h2d for ka, kb in kernels)
    copy_us = _length(h2d)
    return busy, copy_us / 1e3, (overlap / copy_us if copy_us else 0.0)
