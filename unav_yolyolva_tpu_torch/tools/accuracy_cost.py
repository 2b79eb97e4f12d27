"""The mAP cost of the bf16 compute policy (the port of the root
tools/accuracy_cost.py).

    python -m unav_yolyolva_tpu_torch.tools.accuracy_cost [--epochs 24]
        [--train-batch 16] [--eval-batch 32] [--videos 128] [--seed 0]
        [--out FILE] [--root DIR] [--device cuda|cpu] [--tiny]

Trains the flagship model once at fp32 on a learnable synthetic dataset
(make_synthetic_dataset: 128 videos of 160-224 frames, 100 classes, three
class-coded feature bumps a video, a quarter of them for validation, the
root tool's call) through the port's Batcher, make_train_step and
train_one_epoch, with the root tool's config (lr 4e-4, 2 warmup epochs,
weight decay 1e-4, the eval protocol's NMS), then evaluates the SAME weights
under each protocol:

    fp32_exact    the reference protocol
    bf16_exact    tpu.compute_dtype bfloat16 (the bf16 kernels)

The root tool's two approx_topk protocols collapse into these: the port's
tpu.approx_topk is the exact top-k (eval/step.py). As in the root tool, the
raw trained weights are evaluated, not the EMA (use_ema false): at this
scale (~10^2-10^3 steps) EMA(0.999) is still mostly the random init, which
floors every mAP near zero and leaves the deltas noise.

Prints one JSON object as its last line (avg_mAP per protocol,
delta_vs_fp32_exact = mAP - fp32_exact's, the kernel launches each protocol
served through, the device and nvidia-smi's name and power limit) and writes
it to --out if given. The dataset goes to --root, else to a temporary
directory that is removed at the end. Runs on CUDA unless --device cpu;
--tiny is a tiny width for the CPU tests, whose numbers mean nothing.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from typing import Dict

T, NCLS = 224, 100
PROTOCOLS = (("fp32_exact", "float32"), ("bf16_exact", "bfloat16"))
TINY = {"num_classes": 5, "max_seq_len": 64,
        "model": {"raw_input_dim_V": 64, "raw_input_dim_A": 16, "input_dim_V": 32,
                  "input_dim_A": 32, "embd_dim": 32, "head_dim": 32},
        "test_cfg": {"pre_nms_topk": 100, "max_seg_num": 20}}


def build_cfg(synth: Dict, batch_size: int, epochs: int, compute_dtype: str = "float32",
              tiny: bool = False) -> Dict:
    """The root tool's build_cfg, at a tiny width with tiny=True."""
    from ..core import load_config_dict

    seq_len, ncls = (TINY["max_seq_len"], TINY["num_classes"]) if tiny else (T, NCLS)
    return load_config_dict({
        "dataset": {"json_file": synth["json_file"], "feat_folder": synth["feat_folder"],
                    "num_classes": ncls, "max_seq_len": seq_len, "max_num_events": 16},
        "loader": {"batch_size": batch_size, "num_workers": 2},
        "model": {"use_abs_pe": True, "class_aware": True,
                  **(TINY["model"] if tiny else {})},
        "opt": {"learning_rate": 4e-4, "epochs": epochs, "warmup_epochs": 2,
                "weight_decay": 1e-4},
        "train_cfg": {"loss_weight": 1},
        "test_cfg": {"pre_nms_topk": 2000, "max_seg_num": 100, "min_score": 0.001,
                     "nms_sigma": 0.4, "iou_threshold": 0.7,
                     **(TINY["test_cfg"] if tiny else {})},
        "tpu": {"compute_dtype": compute_dtype},
    })


def _launch_counts() -> Dict[str, int]:
    from ..ops.fused_csp import fused_csp
    from ..ops.fused_mhca import fused_mhca
    from ..ops.fused_nms import multiclass_soft_nms

    return {"mhca": fused_mhca.launches, "csp": fused_csp.launches,
            "mhca_bf16": fused_mhca.bf16_launches, "csp_bf16": fused_csp.bf16_launches,
            "nms": multiclass_soft_nms.launches}


def train(synth: Dict, args, device) -> tuple:
    """Trains at fp32 for args.epochs; returns (model, empty_label_ids)."""
    from ..data.dataset import UnAV100Dataset
    from ..data.pipeline import make_batcher
    from ..models import build_model
    from ..train import create_train_state, make_optimizer, make_train_step, train_one_epoch

    cfg = build_cfg(synth, args.train_batch, args.epochs, tiny=args.tiny)
    dataset = UnAV100Dataset(True, ("train",), **cfg["dataset"])
    empty = dataset.get_attributes()["empty_label_ids"]
    cfg["train_cfg"]["head_empty_cls"] = empty
    cfg["model"]["train_cfg"] = cfg["train_cfg"]
    with make_batcher(dataset, cfg, True, seed=1, device=device) as batcher:
        model = build_model(cfg, device=device, seed=args.seed)
        optimizer, schedule = make_optimizer(model, cfg["opt"], len(batcher),
                                             cfg["train_cfg"]["clip_grad_l2norm"])
        state = create_train_state(model, optimizer, cfg["train_cfg"]["init_loss_norm"])
        step = make_train_step(model, optimizer, cfg, device=device)
        t0 = time.time()
        for epoch in range(args.epochs):
            _, losses = train_one_epoch(state, batcher, step, args.seed, epoch,
                                        print_freq=10_000, schedule=schedule,
                                        log=lambda *a, **k: None)
            if epoch % 4 == 0 or epoch == args.epochs - 1:
                print(f"# epoch {epoch}: final_loss={losses.get('final_loss', float('nan')):.4f}"
                      f" ({time.time() - t0:.0f}s)", flush=True)
    return state.model, empty


def evaluate(weights: Dict, synth: Dict, empty, compute_dtype: str, args, device) -> tuple:
    """(avg mAP, kernel launches) of `weights` served at compute_dtype over
    the validation split."""
    import numpy as np

    from ..data.dataset import UnAV100Dataset
    from ..data.pipeline import make_batcher
    from ..eval.metrics import ANETdetection
    from ..eval.step import make_eval_step
    from ..models import build_model
    from ..train import valid_one_epoch

    cfg = build_cfg(synth, args.eval_batch, args.epochs, compute_dtype, tiny=args.tiny)
    cfg["train_cfg"]["head_empty_cls"] = empty
    cfg["model"]["train_cfg"] = cfg["train_cfg"]
    model = build_model(cfg, device=device, seed=None)
    model.load_state_dict(weights, strict=True)
    dataset = UnAV100Dataset(False, ("validation",), **cfg["dataset"])
    evaluator = ANETdetection(synth["json_file"], "validation",
                              tiou_thresholds=np.linspace(0.1, 0.9, 9))
    step = make_eval_step(model, cfg, device=device)
    before = _launch_counts()
    with make_batcher(dataset, cfg, False, device=device) as batcher:
        mAP, _ = valid_one_epoch(model, batcher, step, -1, evaluator=evaluator,
                                 print_freq=10_000, log=lambda *a, **k: None)
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)
    after = _launch_counts()
    return float(mAP), {k: after[k] - before[k] for k in after}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=24)
    ap.add_argument("--train-batch", type=int, default=16)
    ap.add_argument("--eval-batch", type=int, default=32)
    ap.add_argument("--videos", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0, help="the weights' and droppath's seed")
    ap.add_argument("--out", default=None, help="write the JSON report here")
    ap.add_argument("--root", default=None, help="write the synthetic dataset here (kept)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true", help="a tiny width (CPU tests only)")
    args = ap.parse_args(argv)

    import torch

    from ..core import resolve_device
    from ..data.synthetic import make_synthetic_dataset
    from .bench import nvidia_smi

    device = resolve_device(args.device)
    root = args.root or tempfile.mkdtemp(prefix="accuracy_cost_")
    try:
        seq_len = TINY["max_seq_len"] if args.tiny else T
        dims = ({"visual_dim": TINY["model"]["raw_input_dim_V"],
                 "audio_dim": TINY["model"]["raw_input_dim_A"]} if args.tiny else {})
        synth = make_synthetic_dataset(
            root, num_videos=args.videos, num_classes=TINY["num_classes"] if args.tiny else NCLS,
            min_len=160 * seq_len // T, max_len=seq_len, seed=5, events_per_video=3,
            val_fraction=0.25, **dims)
        model, empty = train(synth, args, device)
        weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
        del model
        results, launches = {}, {}
        for name, dtype in PROTOCOLS:
            results[name], launches[name] = evaluate(weights, synth, empty, dtype, args, device)
            print(f"# {name}: avg mAP {results[name]:.4f}", flush=True)
    finally:
        if args.root is None:
            shutil.rmtree(root, ignore_errors=True)

    base = results["fp32_exact"]
    cuda = device.type == "cuda"
    report = {
        "train_epochs": args.epochs, "videos": args.videos, "seed": args.seed,
        "avg_mAP": results,
        "delta_vs_fp32_exact": {k: v - base for k, v in results.items()},
        "use_ema": False,
        "protocols": "fp32_exact and bf16_exact: the port's tpu.approx_topk is the exact "
                     "top-k, so the root tool's approx_topk protocols are these two",
        "launches": launches,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "nvidia_smi": nvidia_smi() if cuda else None,
        "tiny": args.tiny,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
    sys.exit(0)
