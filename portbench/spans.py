"""The program's spans (`unav.*`, its utils/profiling.py:span) read from a
torch.profiler trace: the kernels each span launched, their device time,
and the device's idle time while the main thread was in it.

A kernel's launch is the CUDA runtime or driver call that the profiler
links to it (the same correlation id), on whatever thread made it. Its
span is the innermost `unav.*` span open on that thread at the launch;
where that thread has none there (the autograd engine's thread runs only
the kernel wrappers' spans), the shortest `unav.*` span on any thread that
holds the launch instant. A span's parent is found the same way from its
start, so a wrapper's span on the backward's thread nests in the main
thread's `unav.train.backward`. A kernel whose launch is not found or lies
in no span is unattributed. A span's device time and launches include its
nested spans'. Idle: the stretches of the window with no kernel running
(portbench/trace.py's arithmetic), intersected with the main thread's spans
of each name; the main thread is the one that opened the window's span.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

from .trace import Interval, length, union

PREFIX = "unav."
LAUNCH_PREFIX = "cu"    # cudaLaunchKernel, cuLaunchKernel, cudaLaunchKernelExC, ...


def _is_kernel(e) -> bool:
    """A kernel on the device: not a copy, a memset or a span's annotation
    on the device's timeline."""
    return (e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("Memcpy", "Memset", "portbench.", PREFIX)))


class _Span:
    __slots__ = ("name", "thread", "start", "end", "parent")

    def __init__(self, e):
        self.name, self.thread = e.name, e.thread
        self.start, self.end = e.time_range.start, e.time_range.end
        self.parent: Optional["_Span"] = None

    def holds(self, t: float) -> bool:
        return self.start <= t <= self.end


class _Thread:
    """One thread's spans, properly nested: the innermost one open at t."""

    def __init__(self, spans: List[_Span]):
        self.spans = sorted(spans, key=lambda s: (s.start, -s.end))
        self.starts = [s.start for s in self.spans]
        self.up: Dict[int, Optional[_Span]] = {}
        stack: List[_Span] = []
        for s in self.spans:
            while stack and not (stack[-1].start <= s.start and s.end <= stack[-1].end):
                stack.pop()
            self.up[id(s)] = stack[-1] if stack else None
            stack.append(s)

    def innermost(self, t: float) -> Optional[_Span]:
        i = bisect.bisect_right(self.starts, t) - 1
        s = self.spans[i] if i >= 0 else None
        while s is not None and not s.holds(t):
            s = self.up[id(s)]
        return s


def _find(threads: Dict[int, _Thread], thread: int, t: float) -> Optional[_Span]:
    """The innermost span open on `thread` at t, else the shortest span on
    any thread holding t."""
    own = threads.get(thread)
    hit = own.innermost(t) if own is not None else None
    if hit is not None:
        return hit
    cands = [s for s in (th.innermost(t) for th in threads.values()) if s is not None]
    return min(cands, key=lambda s: s.end - s.start, default=None)


def _chain(s: Optional[_Span]) -> set:
    """The names of a span and of every span it nests in."""
    names, seen = set(), set()
    while s is not None and id(s) not in seen:
        seen.add(id(s))
        names.add(s.name)
        s = s.parent
    return names


def _overlap(a: List[Interval], b: List[Interval]) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def reduce(prof, window_name: str) -> Dict:
    """reduce_events over a profiler's events."""
    return reduce_events(prof.events(), window_name)


def reduce_events(events, window_name: str) -> Dict:
    """{count, device_s, launches, idle_s} by span name, and the window's
    kernel_s (kernel time, summed), attributed_s (of it, attributed to a
    span), busy_s and window_s, of the events inside the host span
    `window_name`; {} where the trace has no such span."""
    events = list(events)
    win = [e for e in events if e.name == window_name and e.device_type.name == "CPU"]
    if not win:
        return {}
    w0, w1, main = win[0].time_range.start, win[0].time_range.end, win[0].thread

    spans = [_Span(e) for e in events if e.device_type.name == "CPU"
             and e.name.startswith(PREFIX) and w0 <= e.time_range.start
             and e.time_range.end <= w1]
    by_thread: Dict[int, List[_Span]] = {}
    for s in spans:
        by_thread.setdefault(s.thread, []).append(s)
    threads = {k: _Thread(v) for k, v in by_thread.items()}
    for th in threads.values():
        for s in th.spans:
            s.parent = th.up[id(s)]
            if s.parent is None:
                others = {k: v for k, v in threads.items() if k != s.thread}
                s.parent = _find(others, -1, s.start)

    kernels = [e for e in events if _is_kernel(e)
               and e.time_range.end > w0 and e.time_range.start < w1]
    launch_ids = {e.id for e in kernels}
    launches: Dict[int, object] = {}
    for e in events:
        if e.device_type.name == "CPU" and e.id in launch_ids \
                and e.name.startswith(LAUNCH_PREFIX):
            launches.setdefault(e.id, e)

    out = {"count": {}, "device_s": {}, "launches": {}, "idle_s": {}}
    for s in spans:
        out["count"][s.name] = out["count"].get(s.name, 0) + 1
    kernel_s = attributed_s = 0.0
    intervals: List[Interval] = []
    for k in kernels:
        a, b = max(k.time_range.start, w0), min(k.time_range.end, w1)
        intervals.append((a, b))
        d = (b - a) / 1e6
        kernel_s += d
        launch = launches.get(k.id)
        s = _find(threads, launch.thread, launch.time_range.start) if launch else None
        if s is None:
            continue
        attributed_s += d
        for n in _chain(s):
            out["device_s"][n] = out["device_s"].get(n, 0.0) + d
            out["launches"][n] = out["launches"].get(n, 0) + 1

    busy = union([i for i in intervals if i[1] > i[0]])
    idle, at = [], w0
    for a, b in busy:
        if a > at:
            idle.append((at, a))
        at = max(at, b)
    if w1 > at:
        idle.append((at, w1))
    for name in {s.name for s in threads[main].spans} if main in threads else ():
        mine = union([(s.start, s.end) for s in threads[main].spans if s.name == name])
        out["idle_s"][name] = _overlap(mine, idle) / 1e6
    out.update(kernel_s=kernel_s, attributed_s=attributed_s, busy_s=length(busy) / 1e6,
               window_s=(w1 - w0) / 1e6)
    return out
