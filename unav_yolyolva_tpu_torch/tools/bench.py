"""The port bench: eval videos/s and train clips/s of the flagship model on
the card (the port of the root bench.py).

    python -m unav_yolyolva_tpu_torch.tools.bench [--iters 10] [--windows 5]
        [--h2d] [--no-train] [--compute-dtype float32|bfloat16] [--seed 0]
        [--eval-batch 64] [--nms-candidates 0] [--train-batch 8]
        [--train-dtype float32|bfloat16] [--commit SHA]

Eval: the protocol of configs/avel_unav100_eval.yaml (B=64, T=224, 100
classes, pre_nms_topk 2000, max_seg_num 100, multiclass Gaussian
Soft-NMS) at --compute-dtype (fp32 by default; bfloat16 is the bf16
policy of configs/avel_unav100_bf16.yaml, fp32 weights), weights from
--seed, one batch from synthetic_eval_batch; --eval-batch sets the batch
(the root bench's BENCH_BATCH) and --nms-candidates tpu.nms_max_candidates
(BENCH_NMS_CAND; 0, the default, is the reference-exact set). Each
step's detections are copied to pinned host memory and read one step
later, as valid_one_epoch does. By default the batch is already on the
device (the root bench's default); with --h2d every step copies one of two
pinned host batches (data/pipeline.py's pinned_empty) on the eval step's
copy stream, the copy included in the time.

Train: the protocol of configs/avel_unav100.yaml (B=8, T=224, fp32, AdamW
+ clip + warmup/cosine, droppath 0.1, EMA) on synthetic_train_batch
batches already on the device, at --train-dtype, which is --compute-dtype
unless given (bfloat16: the bf16 train step of
configs/avel_unav100_bf16.yaml, through the bf16 backward kernels; fp32
parameters, optimizer state and EMA); --train-batch sets the batch (the root
bench's BENCH_TRAIN_BATCH and BENCH_TRAIN_DTYPE, whose defaults there are 64
and bfloat16); --no-train skips it. It reports its train_batch and
train_dtype.

Both: one warm-up window, then --windows (at least 5) timed windows of
--iters steps, host clock, the device synchronized at each window's end;
the value is the median window, spread_pct = (max - min) / median. Beside
it: the busy share (the union of the kernels' device intervals over the
wall time of one torch.profiler window outside the timed ones), peak
device memory (torch.cuda.max_memory_allocated), the card's name and power
limit (nvidia-smi) and the commit (`git rev-parse HEAD`, else --commit).

Model FLOPs (tools/flops.py:model_flops, counted once per configuration in
a process, outside the timed windows): flops_per_video (GFLOP, the eval forward) and
train_flops_per_clip (GFLOP, the train step's forward and backward), the same
whatever kernels run; mfu_vs_bf16_peak = flops_per_video x videos/s / (peak
x world_size) and train_mfu_vs_bf16_peak likewise, against the card's dense
bf16 tensor-core peak whatever the run's dtype, as the root bench does:
989 TFLOP/s for an H100 SXM (NVIDIA H100 80GB HBM3) at its 700 W limit
(nvidia_smi in the line says the limit the card ran at); an unknown card
gives null. vs_baseline is videos/s over BASELINE_MEASURED.json's
pytorch_cpu_eval_videos_per_sec (null without the file).

The last line of standard output is one JSON object with the root
bench.py's key names where they apply. `--device cpu --tiny` runs a tiny
width on the CPU, for the tests only: its numbers are not the card's.

Data parallel under torchrun (`python -m torch.distributed.run
--nproc_per_node N -m unav_yolyolva_tpu_torch.tools.bench ...`): every rank
makes the same global batches and serves or trains its row block of them
(parallel/mesh.py:shard_batch); videos/s, clips/s and the FLOP counts
are of the global batch, the MFUs per card, the busy share and memory are
rank 0's, and rank 0 alone prints the JSON line, with world_size. Each
batch must divide over the ranks.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import subprocess
import sys
import time

import yaml

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY = {
    "dataset": {"num_classes": 5, "max_seq_len": 64, "max_num_events": 8},
    "loader": {"batch_size": 2},
    "model": {"raw_input_dim_V": 64, "raw_input_dim_A": 16, "input_dim_V": 32,
              "input_dim_A": 32, "embd_dim": 32, "head_dim": 32},
    "test_cfg": {"pre_nms_topk": 100, "max_seg_num": 20},
}


def _deep_update(dst, src):
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def load_protocol(name: str, tiny: bool):
    from ..core import load_config_dict

    with open(os.path.join(ROOT, "configs", name)) as f:
        raw = yaml.safe_load(f)
    return load_config_dict(_deep_update(raw, TINY) if tiny else raw)


# dense bf16 tensor-core FLOP/s by torch.cuda.get_device_name: the H100 SXM's
# 989 TFLOP/s at its 700 W limit
PEAK_BF16 = {"NVIDIA H100 80GB HBM3": 989e12}
BASELINE = os.path.join(ROOT, "BASELINE_MEASURED.json")


def baseline_videos_per_sec():
    """The reference's CPU eval videos/s (BASELINE_MEASURED.json), or None."""
    if not os.path.exists(BASELINE):
        return None
    with open(BASELINE) as f:
        return json.load(f).get("pytorch_cpu_eval_videos_per_sec")


_FLOPS: dict = {}


def counted_flops(cfg, batch: int, train: bool) -> int:
    """tools/flops.py:model_flops, counted once per configuration and batch
    in a process (chip_smoke.py runs main several times in one); the count
    depends on no tpu.* setting (fp32 always, decode and NMS not counted)."""
    key = (json.dumps({k: v for k, v in cfg.items() if k != "tpu"}, sort_keys=True,
                      default=repr), batch, train)
    if key not in _FLOPS:
        from .flops import model_flops

        _FLOPS[key] = model_flops(cfg, batch, train)
    return _FLOPS[key]


def mfu(flops_per_item, items_per_sec, peak, world_size):
    """Model-FLOP utilization per card, or None without a known peak."""
    if not peak:
        return None
    return flops_per_item * items_per_sec / (peak * world_size)


def nvidia_smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def git_commit():
    try:
        res = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
                             text=True, timeout=60)
    except FileNotFoundError:
        return None
    return res.stdout.strip() if res.returncode == 0 else None


def windowed(run, iters: int, windows: int, per_step: int, sync):
    """(median, spread_pct, windows) of per_step * iters / seconds over
    `windows` timed calls of run(iters), after one warm-up call."""
    run(iters)
    sync()
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        run(iters)
        sync()
        rates.append(per_step * iters / (time.perf_counter() - t0))
    med = statistics.median(rates)
    return med, (max(rates) - min(rates)) / med * 100, rates


def profiled(run, iters: int, sync):
    """(busy share, h2d copy ms, share of the copy under a kernel) of one
    profiled run(iters); None for each without a card."""
    import torch

    from ..utils.profiling import busy_and_overlap, trace

    if not torch.cuda.is_available():
        return None, None, None
    sync()
    with trace() as prof:
        t0 = time.perf_counter()
        run(iters)
        sync()
        wall = time.perf_counter() - t0
    return busy_and_overlap(prof, wall)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10, help="steps per window")
    ap.add_argument("--windows", type=int, default=5, help="timed windows (at least 5)")
    ap.add_argument("--h2d", action="store_true",
                    help="copy a pinned host batch every eval step")
    ap.add_argument("--no-train", action="store_true")
    ap.add_argument("--compute-dtype", default="float32", choices=("float32", "bfloat16"),
                    help="the compute dtype (tpu.compute_dtype) of eval, and of train unless "
                         "--train-dtype is given")
    ap.add_argument("--eval-batch", type=int, default=None,
                    help="the eval batch (default: the protocol's, 64)")
    ap.add_argument("--nms-candidates", type=int, default=0,
                    help="tpu.nms_max_candidates of the eval step (0: the reference-exact set)")
    ap.add_argument("--train-batch", type=int, default=None,
                    help="the train batch (default: the protocol's, 8)")
    ap.add_argument("--train-dtype", default=None, choices=("float32", "bfloat16"),
                    help="the train half's compute dtype (default: --compute-dtype)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--commit", default=None,
                    help="the commit to record where the checkout has no git metadata")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true", help="a tiny width (CPU tests only)")
    args = ap.parse_args(argv)
    if args.windows < 5 or args.iters < 1:
        ap.error("--windows must be at least 5 and --iters at least 1")
    batches = [b for b in (args.eval_batch, args.train_batch) if b is not None]
    if min(batches, default=1) < 1 or args.nms_candidates < 0:
        ap.error("--eval-batch and --train-batch must be positive, --nms-candidates at least 0")

    from ..parallel import make_mesh

    mesh = make_mesh(-1, args.device)
    try:
        if args.train_batch is not None and args.train_batch % mesh.world_size:
            raise ValueError(f"--train-batch {args.train_batch} does not divide over world "
                             f"size {mesh.world_size}")
        record = _bench(args, mesh)
    finally:
        mesh.close()
    if mesh.is_main:
        print(json.dumps(record), flush=True)
    return 0


def _bench(args, mesh) -> dict:
    import torch

    from ..data.pipeline import pinned_empty
    from ..data.synthetic import synthetic_eval_batch, synthetic_train_batch
    from ..eval.step import fetch_detections, make_eval_step
    from ..models import build_model
    from ..parallel import shard_batch
    from ..train import create_train_state, make_optimizer, make_train_step

    dev = mesh.device
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    record = {"metric": "eval_videos_per_sec"}
    peak = PEAK_BF16.get(torch.cuda.get_device_name(dev)) if cuda else None

    # ---- eval ---------------------------------------------------------------
    cfg = load_protocol("avel_unav100_eval.yaml", args.tiny)
    cfg["tpu"]["compute_dtype"] = args.compute_dtype
    cfg["tpu"]["nms_max_candidates"] = args.nms_candidates
    if args.eval_batch is not None:
        cfg["loader"]["batch_size"] = args.eval_batch
    mcfg = cfg["model"]
    b, t = cfg["loader"]["batch_size"], mcfg["max_seq_len"]
    flops = counted_flops(cfg, b, False) / b
    model = build_model(cfg, device=dev, seed=args.seed)
    eval_step = make_eval_step(model, cfg, mesh=mesh)
    gen = torch.Generator().manual_seed(args.seed + 1)
    host = [shard_batch(synthetic_eval_batch(gen, b, t, mcfg["raw_input_dim_V"],
                                             mcfg["raw_input_dim_A"]), mesh)
            for _ in range(2)]
    if args.h2d and cuda:
        batches = []
        for hb in host:
            pb = {k: pinned_empty(v.shape, v.numpy().dtype) for k, v in hb.items()}
            for k, v in hb.items():
                pb[k].copy_(v)
            batches.append(pb)
    else:
        batches = [{k: v.to(dev) for k, v in host[0].items()}]

    def read(pending):
        dets, done = pending
        if done is not None:
            done.synchronize()
        if not bool(torch.isfinite(dets["scores"]).all()):
            raise AssertionError("non-finite detection scores")

    def run_eval(n):
        pending = None
        for i in range(n):
            fetched = fetch_detections(eval_step(batches[i % len(batches)]))
            if pending is not None:
                read(pending)
            pending = fetched
        read(pending)

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    vps, spread, rates = windowed(run_eval, args.iters, args.windows, b, sync)
    busy, copy_ms, overlap = profiled(run_eval, args.iters, sync)
    base = baseline_videos_per_sec()
    record.update({
        "value": vps, "unit": "videos/s", "spread_pct": spread, "windows": rates,
        "vs_baseline": vps / base if base else None,
        "flops_per_video": flops / 1e9, "flops_unit": "GFLOP",
        "mfu_vs_bf16_peak": mfu(flops, vps, peak, mesh.world_size),
        "nms_candidates": args.nms_candidates,
        "protocol": ("h2d_pinned_copy_included" if args.h2d and cuda
                     else "device_resident_inputs") + "_median_of_windows",
        "batch": b, "seq_len": t, "num_classes": mcfg["num_classes"],
        "dtype": cfg["tpu"]["compute_dtype"], "iters": args.iters,
        "busy_share": busy, "h2d_copy_ms_per_window": copy_ms if args.h2d else None,
        "h2d_copy_share_under_kernels": overlap if args.h2d else None,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
    })
    del eval_step, model, batches, host

    # ---- train --------------------------------------------------------------
    if not args.no_train:
        tcfg = load_protocol("avel_unav100.yaml", args.tiny)
        tcfg["tpu"]["compute_dtype"] = args.train_dtype or args.compute_dtype
        if args.train_batch is not None:
            tcfg["loader"]["batch_size"] = args.train_batch
        tm = tcfg["model"]
        tb_, tt = tcfg["loader"]["batch_size"], tm["max_seq_len"]
        tflops = counted_flops(tcfg, tb_, True) / tb_
        model = build_model(tcfg, device=dev, seed=args.seed)
        optimizer, _ = make_optimizer(model, tcfg["opt"], 100,
                                      tcfg["train_cfg"]["clip_grad_l2norm"])
        state = create_train_state(model, optimizer, tcfg["train_cfg"]["init_loss_norm"])
        train_step = make_train_step(model, optimizer, tcfg, mesh=mesh)
        tbatches = [{k: v.to(dev) for k, v in shard_batch(synthetic_train_batch(
            gen, tb_, tt, tm["raw_input_dim_V"], tm["raw_input_dim_A"], tm["num_classes"],
            tcfg["dataset"]["max_num_events"]), mesh).items()} for _ in range(2)]

        def run_train(n):
            for i in range(n):
                losses = train_step(state, tbatches[i % 2], args.seed)
            if not torch.isfinite(losses["final_loss"]):
                raise AssertionError("non-finite train loss")

        if cuda:
            torch.cuda.reset_peak_memory_stats()
        cps, tspread, trates = windowed(run_train, args.iters, args.windows, tb_, sync)
        tbusy, _, _ = profiled(run_train, args.iters, sync)
        record.update({
            "train_clips_per_sec": cps, "train_spread_pct": tspread, "train_windows": trates,
            "train_batch": tb_, "train_dtype": tcfg["tpu"]["compute_dtype"],
            "train_flops_per_clip": tflops / 1e9,
            "train_mfu_vs_bf16_peak": mfu(tflops, cps, peak, mesh.world_size),
            "train_busy_share": tbusy,
            "train_peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda
            else None,
        })

    record.update({
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "nvidia_smi": nvidia_smi() if cuda else None,
        "commit": git_commit() or args.commit, "seed": args.seed, "tiny": args.tiny,
        "world_size": mesh.world_size,
    })
    return record


if __name__ == "__main__":
    sys.exit(main())
