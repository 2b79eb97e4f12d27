"""The readings that the limits of `correct` are set from, several seeds in
one process (the benchmark's own runs never run this).

    python -m portbench.calibrate --workload <name> --seeds 1 2 3 \
        [--what program control] [--detail]

For each seed: the run's weights and traffic; `program` serves the checked
pool batches through the program's step as a run does and compares its
output with the reference; `control` puts the reference at the precision
below the configuration's (TF32 for float32, fp8 for bfloat16; reference/
prec.py) in the program's place. One JSON line per seed and side, with the
compared numbers; --detail adds the off videos (pool batch, row, gap).
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time
from typing import Dict, List

import torch

from . import check, common, spec, traffic
from .reference import decode as ref_decode
from .reference import model as ref_model
from .reference import prec

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


@torch.no_grad()
def control_detections(model, cfg: Dict, batch: Dict, dev) -> Dict[str, torch.Tensor]:
    """The reference's own detections of a host batch, at the precision that
    is in force (the control runs it under prec.precision)."""
    m = cfg["model"]
    b = {k: v.to(dev) for k, v in batch.items()}
    out = model({"visual": b["visual"], "audio": b["audio"], "mask": b["mask"].bool()})
    points = [torch.from_numpy(p).to(dev) for p in ref_model.generate_points(
        m["max_seq_len"], m["regression_range"], m["scale_factor"])]
    return {k: v.cpu() for k, v in ref_decode.detections(out, points, b, cfg["test_cfg"]).items()}


def eval_seed(w: Dict, seed: int, what: List[str], detail: bool, dev) -> List[Dict]:
    from unav_yolyolva_tpu_torch.eval.step import fetch_detections, make_eval_step

    cfg, mix, judge = w["config_file"]["config"], w["traffic_file"], check.judge(w["name"])
    tol = judge["video_tol"]
    state = common.make_weights(cfg, seed, dev)
    pool = traffic.pool(common.sub_seed(seed, 2), mix, cfg, dev)
    rng = random.Random(common.sub_seed(seed, 3))
    checked = sorted(rng.sample(range(len(pool)), judge["check_batches"]))
    sides: Dict[str, list] = {}
    if "program" in what:
        step = make_eval_step(common.program_model(cfg, state, dev), cfg, device=dev)
        outs = []
        for k in checked:
            dets, done = fetch_detections(step(pool[k]))
            if done is not None:
                done.synchronize()
            outs.append((k, dets))
        sides["program"] = outs
        del step
        common.free(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = common.reference_model(cfg, state, dev).eval()
    cands = {k: check.reference_candidates(model, cfg, pool[k], dev, tol) for k in checked}
    if "control" in what:
        with prec.precision(CONTROL[cfg["tpu"]["compute_dtype"]]):
            sides["control"] = [(k, control_detections(model, cfg, pool[k], dev))
                                for k in checked]
    out = []
    for side, outs in sides.items():
        t0 = time.time()
        line = {"seed": seed, "side": side,
                **check.compare_eval(outs, cands.__getitem__, cfg["test_cfg"], tol)}
        if detail:
            line["off"] = [[k, v, g] for k, dets in outs for v, g in enumerate(
                check.replay_gaps(dets, cands[k], cfg["test_cfg"], tol).tolist()) if g > tol][:16]
        line["compare_s"] = time.time() - t0
        out.append(line)
    del model, cands
    common.free(dev)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--what", nargs="+", default=["program", "control"],
                    choices=("program", "control"))
    ap.add_argument("--detail", action="store_true")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    w = spec.cell(spec.benchmark(), args.workload)
    dev = torch.device(args.device)
    for seed in args.seeds:
        t0 = time.time()
        kind = w["traffic_file"]["kind"]
        if kind == "eval":
            lines = eval_seed(w, seed, args.what, args.detail, dev)
        else:
            lines = spec.mode(kind).calibrate_seed(w, seed, args.what, dev)
        for line in lines:
            line["seconds"] = time.time() - t0
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
