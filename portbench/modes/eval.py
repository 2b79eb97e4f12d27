"""The eval (serving) mode: the program's eval step over a pool of pinned
host batches in a closed loop with one batch in flight, as the program's
valid_one_epoch serves: batch i+1 is dispatched before batch i's
detections are read.

Set-up: the weights and the pool from the seed, the program's model with
the weights (strict), its eval step, `warm` batches served. The window:
batches served for `seconds`, then the last one read. A served video is a
row with a nonzero valid length (a zero-padded row is no video). Each
batch's latency runs from the call of the step on it until its detections
are readable on the host; the step's host time until the step call (with
the start of the copy of its detections) returns. A traced run starts the
profiler `profile_after_s` into the window, serves one lead-in batch, and
reads the trace over the next `profile_steps` batches; after the window it
times each kernel entry point alone. Then the program is freed and the
detections of every window batch that came from the pool batches that the
check draws from the seed (`check_batches` of the cell's limits file) are
compared with the reference's (portbench/check.py).
"""

from __future__ import annotations

import random
import time
from typing import Dict

import torch

from .. import check, common, kernels, traffic, work


def run(ctx: Dict) -> Dict:
    from unav_yolyolva_tpu_torch.eval.step import fetch_detections, make_eval_step

    cfg, mix, seed, dev = ctx["cfg"], ctx["mix"], ctx["seed"], ctx["device"]
    state = common.make_weights(cfg, seed, dev)
    pool = traffic.pool(common.sub_seed(seed, 2), mix, cfg, dev)
    model = common.program_model(cfg, state, dev)
    step = make_eval_step(model, cfg, device=dev)
    n_pool, judge = len(pool), ctx["judge"]
    real = [int(b["mask"].any(1).sum()) for b in pool]
    rng = random.Random(common.sub_seed(seed, 3))
    checked = set(rng.sample(range(n_pool), judge["check_batches"]))

    def read(pending):
        dets, done = pending
        if done is not None:
            done.synchronize()
        return dets

    for i in range(mix["warm"]):
        read(fetch_detections(step(pool[i % n_pool])))
    common.sync(dev)
    setup_s = time.time() - ctx["t_start"]

    sub = common.SubWindow(dev) if ctx["trace"] else None
    kept, lat, host, served = [], [], [], 0
    prof_lead = prof_first = prof_last = None
    t0 = time.perf_counter()
    end = t0 + ctx["seconds"]
    pending, i = None, 0
    while True:
        if sub is not None and prof_lead is None \
                and time.perf_counter() - t0 >= mix["profile_after_s"]:
            sub.start()
            prof_lead = i
        if prof_lead is not None and prof_first is None and i - prof_lead == 1:
            sub.open()
            prof_first = i
        if prof_first is not None and prof_last is None and i - prof_first == mix["profile_steps"]:
            pending = _drain(pending, read, kept, checked, lat)
            sub.stop()
            prof_last = i
        if time.perf_counter() >= end and (sub is None or prof_last is not None):
            break
        k = i % n_pool
        with torch.profiler.record_function("portbench.step"):
            t_call = time.perf_counter()
            fetched = fetch_detections(step(pool[k]))
            host.append(time.perf_counter() - t_call)
        with torch.profiler.record_function("portbench.read"):
            pending = _drain(pending, read, kept, checked, lat)
        pending = (fetched, t_call, k)
        served += real[k]
        i += 1
    _drain(pending, read, kept, checked, lat)
    window_s = time.perf_counter() - t0
    dev_block = common.card(dev)

    record = {"kind": "eval", "items": served, "attempted": served, "failed": 0,
              "window_s": window_s, "latencies_s": lat, "host_step_s": host,
              "setup_s": setup_s, "flops_per_item": ctx["config_file"]["flops"]["eval_per_video"],
              "device": dev_block}
    if sub is not None:
        sub.reduce()
        traced = sum(real[j % n_pool] for j in range(prof_lead, prof_last))
        record.update(trace=sub.reduced, untraced_items=served - traced,
                      untraced_s=window_s - sub.wall_s)
        if dev.type == "cuda":
            calls = work.step_calls(cfg, mix["batch"], train=False)
            record["kernels"] = kernels.time_alone(calls, dev, common.sub_seed(seed, 4))
    del step, model
    common.free(dev)
    record["check"] = check.eval_outputs(cfg, state, pool, kept, judge, dev)
    return record


def _drain(pending, read, kept, checked, lat):
    """Read a pending batch's detections and record its latency; keep the
    detections of the checked pool batches. Returns None."""
    if pending is not None:
        fetched, t_call, k = pending
        dets = read(fetched)
        lat.append(time.perf_counter() - t_call)
        if k in checked:
            kept.append((k, dets))
    return None
