"""The train mode: the program's train step (make_train_step on a
create_train_state state) over a pool of pinned host batches, which it
copies on its copy stream as the program's train loop does.

Set-up builds the one state the window uses, from the run's weights,
resumed at update `resume_epoch` x iterations an epoch (past the warmup, so
that each update moves the parameters and the EMA by the schedule's full
rate): the step count and the optimizer's count with each parameter's AdamW
step, as the program's checkpoint path loads them, the moments zero and the
EMA at the weights. It drives that state through its first `warm` steps on
distinct pool batches, through the window's own call and feed: the losses
of the first `checked_steps` (the cell's limits file), the gradient the
first update took (its first moment over 1 - beta1), and the parameters
and the EMA after `checked_steps` are kept for the check. The window: steps
for `seconds`, the device synchronized at its end; each step's host time
until the step call returns. A traced run starts the profiler
`profile_after_s` into the window, takes one lead-in step, reads the trace
over the next `profile_steps` steps, and after the window times each
kernel entry point alone. Then the program is freed and the reference takes
the same first steps from the same state, batches and seed
(portbench/check.py).
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List

import torch

from .. import check, common, kernels, traffic, work
from ..reference import prec
from ..reference import train as ref_train


def resume_count(mix: Dict, iters: int) -> int:
    """The update count the run's state resumes at."""
    return mix["resume_epoch"] * iters


def _program(cfg: Dict, state_dict, iters: int, count: int, dev):
    from unav_yolyolva_tpu_torch.train import (create_train_state, make_optimizer,
                                               make_train_step)

    model = common.program_model(cfg, state_dict, dev)
    optimizer, _ = make_optimizer(model, cfg["opt"], iters,
                                  cfg["train_cfg"]["clip_grad_l2norm"])
    state = create_train_state(model, optimizer, cfg["train_cfg"]["init_loss_norm"])
    _resume(state, count)
    return state, make_train_step(model, optimizer, cfg, device=dev)


def _resume(state, count: int) -> None:
    """Put the program's state at update `count` through its optimizer's
    load_state_dict, as train/checkpoint.py:load_checkpoint resumes one:
    the optimizer's count, each parameter's AdamW step, zero moments, and
    the state's step count."""
    opt = state.optimizer
    inner = opt.state_dict()[opt.KEY]
    params = [p for g in opt.inner.param_groups for p in g["params"]]
    index = [i for g in inner["param_groups"] for i in g["params"]]
    inner["state"] = {i: {"step": torch.tensor(float(count)), "exp_avg": torch.zeros_like(p),
                          "exp_avg_sq": torch.zeros_like(p)} for i, p in zip(index, params)}
    opt.load_state_dict({"count": count, opt.KEY: inner})
    state.step = count


def first_steps(state, step, pool: List[Dict], seed: int, mix: Dict, n: int) -> Dict:
    """Drive the program's state through its first `warm` steps; what the
    check compares of the first `n`."""
    losses, seen = [], {}
    for i in range(mix["warm"]):
        out = step(state, pool[i % len(pool)], seed)
        losses.append(out)
        if i == 0:
            opt = state.optimizer
            seen["grad1"] = {name: _moment(opt, p) / (1.0 - 0.9)
                             for name, p in zip(opt.names, opt.params)}
        if i == n - 1:
            seen["params"] = {k: v.detach().clone() for k, v in state.model.named_parameters()}
            seen["ema"] = {k: v.detach().clone() for k, v in state.ema.named_parameters()}
    seen["losses"] = [{k: float(v) for k, v in out.items()} for out in losses[:n]]
    return seen


def _moment(opt, p) -> torch.Tensor:
    """AdamW's first moment of `p`; zeros where no update has made one."""
    m = opt.inner.state.get(p, {}).get("exp_avg")
    return m.detach() if m is not None else torch.zeros_like(p)


def run(ctx: Dict) -> Dict:
    cfg, mix, seed, dev = ctx["cfg"], ctx["mix"], ctx["seed"], ctx["device"]
    iters = ctx["config_file"]["iters_per_epoch"]
    n_checked, count = ctx["judge"]["checked_steps"], resume_count(mix, iters)
    state_dict = common.make_weights(cfg, seed, dev)
    pool = traffic.pool(common.sub_seed(seed, 2), mix, cfg, dev)
    step_seed = common.sub_seed(seed, 6) & 0x7FFFFFFF
    state, step = _program(cfg, state_dict, iters, count, dev)
    seen = first_steps(state, step, pool, step_seed, mix, n_checked)
    common.sync(dev)
    setup_s = time.time() - ctx["t_start"]

    sub = common.SubWindow(dev) if ctx["trace"] else None
    host, outs = [], []
    prof_lead = prof_first = prof_last = None
    per, n_pool = mix["batch"], len(pool)
    t0 = time.perf_counter()
    end = t0 + ctx["seconds"]
    i = 0
    while True:
        if sub is not None and prof_lead is None \
                and time.perf_counter() - t0 >= mix["profile_after_s"]:
            sub.start()
            prof_lead = i
        if prof_lead is not None and prof_first is None and i - prof_lead == 1:
            sub.open()
            prof_first = i
        if prof_first is not None and prof_last is None and i - prof_first == mix["profile_steps"]:
            sub.stop()
            prof_last = i
        if time.perf_counter() >= end and (sub is None or prof_last is not None):
            break
        with torch.profiler.record_function("portbench.step"):
            t_call = time.perf_counter()
            outs.append(step(state, pool[(mix["warm"] + i) % n_pool], step_seed)["final_loss"])
            host.append(time.perf_counter() - t_call)
        i += 1
    common.sync(dev)
    window_s = time.perf_counter() - t0
    failed = int((~torch.isfinite(torch.stack(outs))).sum()) if outs else 0
    record = {"kind": "train", "items": i * per, "attempted": i * per, "failed": failed * per,
              "window_s": window_s, "host_step_s": host, "setup_s": setup_s,
              "flops_per_item": ctx["config_file"]["flops"]["train_per_clip"],
              "device": common.card(dev)}
    if sub is not None:
        sub.reduce()
        record.update(trace=sub.reduced,
                      untraced_items=(i - (prof_last - prof_lead)) * per,
                      untraced_s=window_s - sub.wall_s)
        if dev.type == "cuda":
            calls = work.step_calls(cfg, per, train=True)
            record["kernels"] = kernels.time_alone(calls, dev, common.sub_seed(seed, 4))
    del state, step, outs
    common.free(dev)
    ref = reference_steps(cfg, state_dict, pool, step_seed, n_checked, iters, count, dev)
    record["check"] = check.compare_train(seen, ref, state_dict)
    return record


def reference_steps(cfg: Dict, state_dict, pool: List[Dict], seed: int, n: int, iters: int,
                    count: int, dev, precision: str = "fp32", rows=None) -> Dict:
    """The reference's first `n` steps from the run's weights resumed at
    update `count`, in the same terms as `first_steps`. `rows` (a slice)
    keeps only those rows of every batch (the check's planted fault)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = common.reference_model(cfg, state_dict, dev)
    st = ref_train.State(model, cfg["train_cfg"]["init_loss_norm"], count)
    seen: Dict = {"losses": []}
    with prec.precision(precision):
        for i in range(n):
            b = {k: v[rows].to(dev) if rows is not None else v.to(dev)
                 for k, v in pool[i % len(pool)].items()}
            losses = ref_train.step(st, b, seed, cfg, iters)
            seen["losses"].append({k: float(v) for k, v in losses.items()})
            if i == 0:
                seen["grad1"] = dict(zip(st.names, ref_train.first_grads(st)))
    seen["params"] = {name: p.detach() for name, p in zip(st.names, st.params)}
    seen["ema"] = dict(zip(st.names, st.ema))
    return seen


def calibrate_seed(w: Dict, seed: int, what: List[str], dev) -> List[Dict]:
    """Readings of the train cell's numbers for one seed: the program's
    first steps, the control (the reference at fp8) and the planted fault of
    half the batch left out, each against the reference."""
    cfg, mix = w["config_file"]["config"], w["traffic_file"]
    iters = w["config_file"]["iters_per_epoch"]
    n, count = check.judge(w["name"])["checked_steps"], resume_count(mix, iters)
    state_dict = common.make_weights(cfg, seed, dev)
    pool = traffic.pool(common.sub_seed(seed, 2), mix, cfg, dev)
    step_seed = common.sub_seed(seed, 6) & 0x7FFFFFFF
    sides = {}
    if "program" in what:
        state, step = _program(cfg, state_dict, iters, count, dev)
        sides["program"] = first_steps(state, step, pool, step_seed, mix, n)
        del state, step
        common.free(dev)
    ref = reference_steps(cfg, state_dict, pool, step_seed, n, iters, count, dev)
    if "control" in what:
        sides["control"] = reference_steps(cfg, state_dict, pool, step_seed, n, iters, count,
                                           dev, precision="fp8")
        sides["half_batch"] = reference_steps(cfg, state_dict, pool, step_seed, n, iters,
                                              count, dev, rows=slice(0, mix["batch"] // 2))
    out = []
    g_ref = check._norms(ref["grad1"])
    moving = check.moving_leaves(ref["grad1"])
    for side, seen in sides.items():
        line = {"seed": seed, "side": side, **check.compare_train(seen, ref, state_dict),
                "losses": [s["final_loss"] for s in seen["losses"]],
                "ref_losses": [s["final_loss"] for s in ref["losses"]]}
        for what, gaps in (
                ("grad", check.leaf_gaps(check._norms(seen["grad1"]), g_ref, g_ref)),
                ("update", check.leaf_gaps(check._norms(seen["params"], state_dict),
                                           check._norms(ref["params"], state_dict), moving)),
                ("ema", check.leaf_gaps(check._norms(seen["ema"], state_dict),
                                        check._norms(ref["ema"], state_dict), moving))):
            vals = sorted(gaps.values())
            line[f"{what}_median_leaf"] = statistics.median(vals)
            line[f"{what}_p90_leaf"] = vals[int(0.9 * (len(vals) - 1))]
            line[f"{what}_worst"] = sorted(gaps.items(), key=lambda kv: -kv[1])[:4]
        out.append(line)
    common.free(dev)
    return out
