"""The comparison that decides `correct`: what the timed path produced,
against the plain reference (portbench/reference/) on the same inputs and
weights, run after the window once the program is freed. The reference
runs in float32 with TF32 off.

Eval: every window batch served from a checked pool batch is judged video
by video against the reference's candidates of that batch (its forward and
decode). The judge replays the multiclass Soft-NMS scan on the reference's
candidates in the order the program emitted its detections: at each of the
program's valid slots it finds the live reference candidate of the same
class nearest to the emitted segment, requires it to be a maximum of the
live scores to within `video_tol` (so an order that only a near-tie decides
passes), takes the gaps of the emitted score (relative) and segment (in
seconds over max(duration, 1 s)), and decays and kills as the scan does.
Where the program emitted fewer than the slots, what the reference still
holds must lie under min_score to within `video_tol`. Candidates that a
rounding of `video_tol` could bring in or leave out (at the top-k cut, the
score threshold, the minimum duration, min_score) may be emitted or not.
A video's gap is the largest of its slots' gaps, and 1 where a slot finds no
candidate, is not a maximum, or a slot is missing. The numbers compared:

- `videos_off`: the videos whose gap is above `video_tol`, over every
  compared window batch (an altered answer, a row left out, a stale batch);
- `gap_median`: the median video gap (the precision of every answer).
"""

from __future__ import annotations

import hashlib
import json
import statistics
from typing import Dict, List, Sequence, Tuple

import torch

from . import common
from .reference import decode as ref_decode
from .reference import model as ref_model


def _limits_file(workload: str) -> Dict:
    from .spec import HERE

    with open(HERE / "limits" / f"{workload}.json") as f:
        return json.load(f)


def limits(workload: str) -> Dict[str, float]:
    """The workload's limits (portbench/limits/<workload>.json)."""
    return _limits_file(workload)["limits"]


def judge(workload: str) -> Dict:
    """The settings that the workload's comparison runs with, beside its
    limits, which they set: eval `video_tol` and `check_batches`, train
    `checked_steps`."""
    return _limits_file(workload)["judge"]


@torch.no_grad()
def reference_candidates(model, cfg: Dict, batch: Dict[str, torch.Tensor], dev,
                         tol: float) -> Dict[str, torch.Tensor]:
    """The reference's forward and widened candidates of a host batch."""
    m, test = cfg["model"], cfg["test_cfg"]
    b = {k: v.to(dev) for k, v in batch.items()}
    out = model({"visual": b["visual"], "audio": b["audio"], "mask": b["mask"].bool()})
    points = [torch.from_numpy(p).to(dev) for p in ref_model.generate_points(
        m["max_seq_len"], m["regression_range"], m["scale_factor"])]
    segs, scores, cls, req, inc = ref_decode.candidates(
        out["cls_logits"], out["offsets"], out["masks"], points,
        pre_nms_thresh=test["pre_nms_thresh"], pre_nms_topk=test["pre_nms_topk"],
        duration_thresh=test["duration_thresh"], tol=tol)
    return {"segs": segs, "seconds": ref_decode.to_seconds(segs, b), "scores": scores,
            "cls": cls, "required": req, "included": inc,
            "duration": b["duration"].float()}


@torch.no_grad()
def replay_gaps(prog: Dict[str, torch.Tensor], cand: Dict[str, torch.Tensor], test_cfg: Dict,
                tol: float) -> torch.Tensor:
    """(B,) each video's gap between the program's detections `prog` and the
    reference's candidates `cand` (see the module's docstring)."""
    dev = cand["scores"].device
    p = {k: v.to(dev) for k, v in prog.items()}
    pv, plab = p["valid"].bool(), p["labels"].long()
    pseg, psc = p["segments"].float(), p["scores"].float()
    b, m = pv.shape
    ninf = float("-inf")
    s = torch.where(cand["included"], cand["scores"].float(), ninf)
    x1, x2 = cand["segs"][..., 0].float(), cand["segs"][..., 1].float()
    cls, req, sec = cand["cls"].long(), cand["required"], cand["seconds"]
    dur = cand["duration"].clamp(min=1.0)[:, None]
    sigma, min_score = test_cfg["nms_sigma"], test_cfg["min_score"]
    lane = torch.arange(s.shape[1], device=dev)[None, :]
    gap = torch.zeros(b, device=dev)
    bad = torch.zeros(b, dtype=torch.bool, device=dev)
    stopped = torch.zeros(b, dtype=torch.bool, device=dev)
    for k in range(m):
        live = s > ninf
        top = torch.where(live & req, s, ninf).amax(1)
        ends = ~pv[:, k] & ~stopped
        bad |= (ends & (top > min_score * (1.0 + tol))) | (pv[:, k] & stopped)
        stopped |= ends
        emit = pv[:, k] & ~stopped
        same = live & (cls == plab[:, k, None])
        d_seg = (sec - pseg[:, k, None, :]).abs().amax(-1) / dur
        d_sc = (s - psc[:, k, None]).abs() / s.abs().clamp(min=1e-6)
        j = torch.where(same, d_seg + d_sc, float("inf")).argmin(1, keepdim=True)
        found = same.gather(1, j)[:, 0]
        sj = s.gather(1, j)[:, 0]
        near = sj >= (1.0 - tol) * top
        g = torch.maximum(d_seg.gather(1, j)[:, 0], d_sc.gather(1, j)[:, 0])
        bad |= emit & ~(found & near)
        gap = torch.where(emit & found, torch.maximum(gap, g), gap)
        sx1, sx2 = x1.gather(1, j), x2.gather(1, j)
        inter = (torch.minimum(sx2, x2) - torch.maximum(sx1, x1)).clamp(min=0.0)
        iou = inter / ((sx2 - sx1 + 1e-6) + (x2 - x1 + 1e-6) - inter)
        w = torch.exp(-(iou * iou) / sigma)
        in_cls = cls == cls.gather(1, j)
        dec = torch.where(in_cls, s * w, s)
        kill = (in_cls & (dec < min_score * (1.0 - tol))) | (lane == j)
        s = torch.where((emit & found)[:, None], dec.masked_fill(kill, ninf), s)
    return torch.where(bad, 1.0, gap.clamp(max=1.0)).cpu()


def compare_eval(outputs: Sequence[Tuple[int, Dict]], cand_of, test_cfg: Dict,
                 tol: float) -> Dict[str, float]:
    """The numbers of the eval comparison: `outputs` [(pool index,
    detections)], `cand_of(k)` the reference's candidates of pool batch k."""
    gaps: List[float] = []
    seen: Dict[bytes, List[float]] = {}
    for k, dets in outputs:
        key = hashlib.sha256(str(k).encode() + b"".join(
            dets[n].cpu().contiguous().numpy().tobytes() for n in sorted(dets))).digest()
        if key not in seen:      # a pool batch served again gives the same bytes
            seen[key] = replay_gaps(dets, cand_of(k), test_cfg, tol).tolist()
        gaps += seen[key]
    srt = sorted(gaps) or [1.0]
    return {"videos_off": float(sum(g > tol for g in gaps)),
            "gap_median": statistics.median(srt), "videos_compared": float(len(gaps)),
            "gap_p99": srt[int(0.99 * (len(srt) - 1))], "gap_max": srt[-1]}


def eval_outputs(cfg: Dict, state, pool: List[Dict], kept, judge: Dict, dev
                 ) -> Dict[str, float]:
    """The eval cell's comparison of the window's kept detections."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = common.reference_model(cfg, state, dev).eval()
    cands: Dict[int, Dict] = {}

    def cand_of(k):
        if k not in cands:
            cands[k] = reference_candidates(model, cfg, pool[k], dev, judge["video_tol"])
        return cands[k]

    out = compare_eval(kept, cand_of, cfg["test_cfg"], judge["video_tol"])
    del model, cands
    common.free(dev)
    return out


def _norms(tensors: Dict[str, torch.Tensor], base: Dict[str, torch.Tensor] = None
           ) -> Dict[str, float]:
    return {k: float((v.double() - (base[k].double() if base is not None else 0.0)).norm())
            for k, v in tensors.items()}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> Dict[str, float]:
    """Each leaf's gap between the program's and the reference's norm, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger."""
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def compare_train(prog: Dict, ref: Dict, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers of the train comparison, between the program's first steps
    `prog` and the reference's `ref` from the weights `start` (the EMA
    starts there too):

    - `loss_gap`: the largest relative gap of a checked step's final loss;
    - `grad_gap`: the worst leaf's gap of the first gradient's norm (the
      clipped gradient as the optimizer took it);
    - `grad_median`: the median leaf's gap of it, steady from seed to seed,
      the number that separates the program from the control (past the
      warmup, Adam's normalization turns the rounding of near-nought
      gradients into full-size steps in both, which the changes' gaps
      carry: PERF.md);
    - `update_p90`: the 90th percentile over the leaves of the gap of the
      norm of the parameters' change over the checked steps, over the
      leaves whose first gradient in the reference is at least a thousandth
      of the median leaf's (the others move by round-off alone);
    - `ema_p90`: the same of the EMA's change.

    The worst leaf's and the median leaf's gaps of the change
    (`update_worst`, `update_median`) are reported beside them and not
    compared: the worst swings with the noise of single small leaves, and
    neither separates the program from the control by three times
    (PERF.md)."""
    loss_gap = max(abs(p["final_loss"] - r["final_loss"]) / abs(r["final_loss"])
                   for p, r in zip(prog["losses"], ref["losses"]))
    g_ref, g_prog = _norms(ref["grad1"]), _norms(prog["grad1"])
    moving = moving_leaves(ref["grad1"])

    def change(what):
        return sorted(leaf_gaps(_norms(prog[what], start), _norms(ref[what], start),
                                moving).values())

    upd, ema = change("params"), change("ema")
    grad = leaf_gaps(g_prog, g_ref, g_ref).values()
    return {"loss_gap": loss_gap, "grad_gap": max(grad), "grad_median": statistics.median(grad),
            "update_p90": _p90(upd), "ema_p90": _p90(ema),
            "update_median": statistics.median(upd), "update_worst": upd[-1],
            "leaves_moving": float(len(moving)), "leaves": float(len(g_ref))}


def moving_leaves(grad1: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose first gradient's norm in the reference is at least a
    thousandth of the median leaf's."""
    g = _norms(grad1)
    med = statistics.median(g.values())
    return [k for k in g if g[k] >= 1e-3 * med]


def _p90(srt: List[float]) -> float:
    return srt[int(0.9 * (len(srt) - 1))]
