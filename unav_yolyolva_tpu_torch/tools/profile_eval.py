"""Where the eval step's time goes on the card.

    python -m unav_yolyolva_tpu_torch.tools.profile_eval [--batches 3] [--seed 0]

Builds the flagship model of configs/avel_unav100_eval.yaml (fp32, B=64,
T=224, random weights from --seed) and, after a warm-up step, reports:
  * the eval step's wall time per batch (host clock around synchronized
    steps) as videos/s;
  * per stage device time from CUDA events: Alignment, stem (embedding +
    TransformerBlocks, everything before the pyramid), pyramid + fusion
    (the FusionModule at batch 2B and the depthwise downsamples), heads,
    decode, Soft-NMS + grid->seconds; and inside the fusion, each CSP
    layer (by level length T) and the text enhancer MHCA;
  * torch.profiler sums of device time by kernel name, and the device busy
    share of the profiled window (kernel time / wall time).
The kernel table also goes to chiprun_out/profile_eval.txt.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..core import load_config, resolve_device
    from ..data.synthetic import synthetic_eval_batch
    from ..eval.decode import decode_batch, postprocess_batch
    from ..eval.step import make_eval_step
    from ..geometry.points import generate_points
    from ..models import build_model

    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    cfg = load_config(os.path.join(ROOT, "configs", "avel_unav100_eval.yaml"))
    mcfg, tcfg = cfg["model"], cfg["test_cfg"]
    model = build_model(cfg, device=dev, seed=args.seed)
    eval_step = make_eval_step(model, cfg, device=dev)
    gen = torch.Generator().manual_seed(args.seed + 1)
    batches = [synthetic_eval_batch(gen, 64, mcfg["max_seq_len"], mcfg["raw_input_dim_V"],
                                    mcfg["raw_input_dim_A"]) for _ in range(args.batches)]
    eval_step(batches[0])                                       # warm-up
    torch.cuda.synchronize()

    walls = []
    for b in batches:
        t0 = time.perf_counter()
        eval_step(b)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"eval_step wall per batch of 64: {[round(w * 1e3, 3) for w in walls]} ms, "
          f"{64 * len(walls) / sum(walls):.1f} videos/s [{smi}]")

    # per-stage device time: CUDA events around the model's submodules
    stages = defaultdict(float)
    pending = []

    def timed(name):
        def pre(mod, inp):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            pending.append([name, ev, None])

        def post(mod, inp, out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            next(p for p in reversed(pending) if p[0] == name and p[2] is None)[2] = ev
        return pre, post

    hooks = []
    for name, mod in (("alignment", model.alignment),
                      ("pyramid+fusion", model.backbone.fusion_module),
                      ("cls_head", model.cls_head), ("reg_head", model.reg_head),
                      ("backbone", model.backbone)):
        pre, post = timed(name)
        hooks += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    ds_pre, ds_post = timed("pyramid+fusion")
    for ds in model.backbone.downsample_list:
        hooks += [ds.register_forward_pre_hook(ds_pre), ds.register_forward_hook(ds_post)]
    fusion = model.backbone.fusion_module
    layers = [(f"top_down_{i}", m) for i, m in enumerate(fusion.top_down_layers)]
    layers += [(f"bottom_up_{i}", m) for i, m in enumerate(fusion.bottom_up_layers)]
    layers.append(("text_enhancer", fusion.text_enhancer))
    lengths = {}
    for name, mod in layers:
        pre, post = timed(name)

        def pre_len(mod, inp, name=name, pre=pre):
            lengths[name] = inp[0].shape[1]
            pre(mod, inp)
        hooks += [mod.register_forward_pre_hook(pre_len), mod.register_forward_hook(post)]

    def event_ms(fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        return out, (a, b)

    decode_ev, nms_ev = [], []
    with torch.inference_mode():
        for b in batches:
            bd = {k: v.to(dev) for k, v in b.items()}
            out = model(bd, with_losses=False)
            pts = [torch.from_numpy(p).to(dev) for p in generate_points(
                mcfg["max_seq_len"], mcfg["regression_range"], mcfg["scale_factor"])]
            cands, ev = event_ms(lambda: decode_batch(
                out["cls_logits"], out["offsets"], out["masks"], pts,
                pre_nms_thresh=tcfg["pre_nms_thresh"], pre_nms_topk=tcfg["pre_nms_topk"],
                duration_thresh=tcfg["duration_thresh"], class_aware=mcfg["class_aware"],
                max_candidates=cfg["tpu"]["nms_max_candidates"]))
            decode_ev.append(ev)
            _, ev = event_ms(lambda: postprocess_batch(
                *cands, num_classes=mcfg["num_classes"], test_cfg=tcfg,
                fps=bd["fps"], duration=bd["duration"],
                feat_stride=bd["feat_stride"], num_frames=bd["feat_num_frames"]))
            nms_ev.append(ev)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    for name, a, b in pending:
        stages[name] += a.elapsed_time(b)
    stages["decode"] = sum(a.elapsed_time(b) for a, b in decode_ev)
    stages["nms+seconds"] = sum(a.elapsed_time(b) for a, b in nms_ev)
    stages["stem"] = stages.pop("backbone") - stages["pyramid+fusion"]
    n = len(batches)
    print(f"stages, device ms per batch of 64 (CUDA events) [{smi}]:")
    main = ("alignment", "stem", "pyramid+fusion", "cls_head", "reg_head", "decode",
            "nms+seconds")
    total = sum(stages[k] for k in main)
    for name in main:
        print(f"  {name:15s} {stages[name] / n:9.3f} ms  {100 * stages[name] / total:5.1f}%")
    print("  inside the fusion (rows 2B=128):")
    for name, mod in layers:
        heads = getattr(getattr(mod, "attn_block", None), "num_heads", None) or mod.n_head
        print(f"    {name:14s} T={lengths[name]:<4d} heads={heads}  {stages[name] / n:8.3f} ms")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            eval_step(b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    lines = [f"profiled {n} eval steps: wall {wall_ms:.1f} ms, device kernel time "
             f"{busy:.1f} ms, busy share {busy / wall_ms:.3f} [{smi}]"]
    lines += [f"  {ms / n:9.3f} ms/batch {100 * ms / busy:5.1f}%  x{cnt // n:<5d} {key[:90]}"
              for key, ms, cnt in rows]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_eval.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines[:26]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
