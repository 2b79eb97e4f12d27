"""Pieces every mode shares: the run's seeds, the weights and the program's
model built from them, the profiled sub-window, and the reading of the
card."""

from __future__ import annotations

import os
import subprocess
import time
from typing import Dict, Optional

import torch

from . import trace, weights
from .reference import model as ref_model

WINDOW_SPAN = "portbench.window"


def process_start() -> float:
    """The process's start on the time.time() clock (from /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def sub_seed(seed: int, what: int) -> int:
    """A seed of its own for each use of the run's seed (weights, traffic,
    steps, checks), below 2**64."""
    return ((seed & ((1 << 48) - 1)) << 8 | what) & ((1 << 63) - 1)


def make_weights(cfg: Dict, seed: int, dev) -> Dict[str, torch.Tensor]:
    """The run's weights in the reference key space (portbench/weights.py)."""
    shapes = {k: v.shape for k, v in ref_model.build(cfg["model"], "meta").state_dict().items()}
    return weights.make(shapes, sub_seed(seed, 1), dev)


def program_model(cfg: Dict, state: Dict[str, torch.Tensor], dev):
    """The program's model at `cfg` with the run's weights, strict."""
    from unav_yolyolva_tpu_torch.models import build_model

    model = build_model(cfg, device=dev, seed=None)
    model.load_state_dict(state, strict=True)
    return model


def reference_model(cfg: Dict, state: Dict[str, torch.Tensor], dev):
    model = ref_model.build(cfg["model"], dev)
    model.load_state_dict(state, strict=True)
    return model


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class SubWindow:
    """The profiled sub-window of a traced run. start() makes a full garbage
    collection and starts the profiler before a lead-in step, open() opens
    the window's span after it, so that the profiler's own start-up (its
    buffers, CUPTI's first records) falls outside what the trace is read
    over, and so does a full collection: the train step's come every ~15 s
    and stall the host 0.15-0.27 s, which in a sub-window of ~2 s would
    weigh eight times its share. stop() after the last step (the device
    synchronized) closes both. `wall_s` is the host time from start() to
    stop(), the collection and the lead-in step included. After the window,
    reduce() reads the trace inside the span into `reduced` (trace.reduce's
    numbers)."""

    def __init__(self, dev):
        self.dev, self.prof, self.span, self.reduced, self.wall_s = dev, None, None, {}, 0.0

    def start(self) -> None:
        import gc

        from torch.profiler import ProfilerActivity, profile

        self.t0 = time.perf_counter()
        gc.collect()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if self.dev.type == "cuda" else [])
        self.prof = profile(activities=acts)
        self.prof.start()

    def open(self) -> None:
        self.span = torch.profiler.record_function(WINDOW_SPAN)
        self.span.__enter__()

    def stop(self) -> None:
        """End the sub-window; `wall_s` counts the profiler's own stop."""
        sync(self.dev)
        self.span.__exit__(None, None, None)
        self.prof.stop()
        self.wall_s = time.perf_counter() - self.t0

    def reduce(self) -> None:
        """Read the trace, once the window has closed."""
        self.reduced = trace.reduce(self.prof, WINDOW_SPAN)
        self.prof = None


def card(dev) -> Dict:
    """The device block of the result line."""
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def power_limit() -> Optional[str]:
    """nvidia-smi's name and power limit of the card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def free(dev) -> None:
    import gc

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
