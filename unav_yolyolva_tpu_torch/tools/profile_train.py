"""Where the train step's time goes on the card.

    python -m unav_yolyolva_tpu_torch.tools.profile_train [--steps 4] [--seed 0]

Builds the flagship model of configs/avel_unav100.yaml (fp32, B=8, T=224,
droppath 0.1, random weights from --seed) and, after two warm-up steps,
reports:
  * make_train_step's wall time per step (host clock around synchronized
    steps) as clips/s, and peak device memory;
  * per stage time on the device's clock from CUDA events, for the same
    sequence of calls as make_train_step: targets, forward (Alignment,
    stem, pyramid + fusion, heads), loss assembly, backward, clip + AdamW,
    EMA (a stage's time includes the device idling while the host enqueues
    it);
  * torch.profiler sums of device time by kernel name over the timed
    steps, and the device busy share: kernel time per step over the wall
    time per step without the profiler (and with it).
The kernel table also goes to chiprun_out/profile_train.txt.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..core import load_config, resolve_device
    from ..data.synthetic import synthetic_train_batch
    from ..geometry.points import concat_points, generate_points
    from ..models import build_model
    from ..models.meta_arch import compute_losses
    from ..train import create_train_state, ema_update, make_optimizer, make_train_step
    from ..train.step import BATCH_KEYS, build_targets, loss_kwargs
    from ..utils.seed import fold_in

    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    cfg = load_config(os.path.join(ROOT, "configs", "avel_unav100.yaml"))
    m = cfg["model"]
    bsz, seq = cfg["loader"]["batch_size"], m["max_seq_len"]
    model = build_model(cfg, device=dev, seed=args.seed)
    opt, _ = make_optimizer(model, cfg["opt"], 100, cfg["train_cfg"]["clip_grad_l2norm"])
    state = create_train_state(model, opt, cfg["train_cfg"]["init_loss_norm"])
    train_step = make_train_step(model, opt, cfg, device=dev)
    gen = torch.Generator().manual_seed(args.seed + 1)
    batches = [synthetic_train_batch(gen, bsz, seq, m["raw_input_dim_V"], m["raw_input_dim_A"],
                                     m["num_classes"], cfg["dataset"]["max_num_events"])
               for _ in range(args.steps)]
    for b in batches[:2]:                                       # warm-up
        train_step(state, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for b in batches:
        t0 = time.perf_counter()
        train_step(state, b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"train_step wall per step of {bsz}: {[round(w * 1e3, 3) for w in walls]} ms, "
          f"{bsz * len(walls) / sum(walls):.1f} clips/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]")

    # the same calls as make_train_step, with CUDA events between them
    pts = torch.from_numpy(concat_points(generate_points(
        seq, m["regression_range"], m["scale_factor"]))).to(dev)
    events = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((name, ev))

    hooks = []
    for name, mod in (("alignment", model.alignment), ("stem", model.backbone),
                      ("pyramid+fusion", model.backbone.fusion_module),
                      ("heads", model.cls_head)):
        hooks.append(mod.register_forward_pre_hook(lambda *a, n=name: mark(n)))
    for b in batches:
        bd = {k: b[k].to(dev) for k in BATCH_KEYS}
        mark("targets")
        ms, mse, ml, gcls, greg = build_targets(bd, pts, seq, m["num_classes"],
                                                m["class_aware"])
        gen_d = torch.Generator(device=dev).manual_seed(fold_in(0, state.step))
        out = model({"visual": bd["visual"], "audio": bd["audio"], "mask": bd["mask"],
                     "m_scores": ms, "m_start_end": mse, "m_labels": ml}, generator=gen_d)
        mark("losses")
        losses, norm = compute_losses(out, gcls, greg, state.loss_normalizer,
                                      **loss_kwargs(cfg))
        mark("backward")
        opt.zero_grad()
        losses["final_loss"].backward()
        mark("clip+adamw")
        opt.step()
        mark("ema")
        ema_update(state.ema, model)
        mark("end")
        state.loss_normalizer, state.step = norm.detach(), state.step + 1
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    stages = {}
    for (name, a), (_, b) in zip(events, events[1:]):
        if name != "end":
            stages[name] = stages.get(name, 0.0) + a.elapsed_time(b)
    n = len(batches)
    total = sum(stages.values())
    print(f"stages, device ms per step of {bsz} (CUDA events) [{smi}]:")
    for name in ("targets", "alignment", "stem", "pyramid+fusion", "heads", "losses",
                 "backward", "clip+adamw", "ema"):
        print(f"  {name:15s} {stages[name] / n:9.3f} ms  {100 * stages[name] / total:5.1f}%")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            train_step(state, b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the optimizer's own profiler range would count its kernels twice
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type.name == "CUDA"
            and not e.key.startswith("Optimizer.")]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    wall = 1e3 * sum(walls) / len(walls)
    lines = [f"profiled {n} train steps: device kernel time {busy / n:.1f} ms/step; busy "
             f"share {busy / n / wall:.3f} of the unprofiled wall ({wall:.1f} ms/step), "
             f"{busy / wall_ms:.3f} of the profiled wall ({wall_ms / n:.1f} ms/step) [{smi}]"]
    lines += [f"  {ms / n:9.3f} ms/step {100 * ms / busy:5.1f}%  x{cnt // n:<5d} {key[:90]}"
              for key, ms, cnt in rows]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_train.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines[:30]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
