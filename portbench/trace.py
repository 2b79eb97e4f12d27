"""The reduction from a torch.profiler trace to the device's busy time and
the run's breakdown.

busy: the union of the kernels' device intervals (copies and memsets are
not kernels), the union arithmetic of the program's
utils/profiling.py:busy_and_overlap. Idle gaps: the stretches of the
profiled window with no kernel running, each named by the host work under
its middle (the innermost host event there, inside the harness's span).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

Interval = Tuple[float, float]


def union(intervals: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def length(intervals: List[Interval]) -> float:
    return sum(b - a for a, b in intervals)


def _is_kernel(e) -> bool:
    """A kernel on the device: not a copy, a memset or a host span's
    annotation on the device's timeline."""
    return (e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("Memcpy", "Memset", "portbench.")))


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def reduce(prof, window_name: str) -> Dict:
    """{busy_s, window_s, device_ops, idle_gaps} of the profiler's events
    inside the host span `window_name` (a record_function around the
    profiled steps, the device synchronized at its end)."""
    events = list(prof.events())
    win = [e for e in events if e.name == window_name and e.device_type.name == "CPU"]
    if not win:
        return {}
    w0, w1 = win[0].time_range.start, win[0].time_range.end           # microseconds
    kernels = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
               for e in events if _is_kernel(e)]
    kernels = union([k for k in kernels if k[1] > k[0]])
    by_name: Dict[str, float] = {}
    for e in events:
        if _is_kernel(e):
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    gaps, at = [], w0
    for a, b in kernels:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if w1 > at:
        gaps.append((at, w1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    host = [e for e in events if e.device_type.name == "CPU" and e.name != window_name]
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        under = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
        span = [e.name for e in under if e.name.startswith("portbench.")]
        inner = min(under, key=lambda e: e.time_range.end - e.time_range.start, default=None)
        label = " > ".join(dict.fromkeys(span[:1] + ([inner.name] if inner else [])))
        named.append([_short(label or "no host work"), (b - a) / 1e6])
    return {"busy_s": length(kernels) / 1e6, "window_s": (w1 - w0) / 1e6,
            "device_ops": [[_short(n), t / 1e6] for n, t in ops], "idle_gaps": named}
