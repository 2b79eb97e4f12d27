"""The plain reference of the eval protocol's tail: decode the per-level
outputs into candidates, multiclass Gaussian Soft-NMS, grid -> seconds.

A frozen, stand-alone copy of the port's plain path (decode_batch with the
full candidate set, the select-and-decay scan line for line, the
conversion to seconds clamped to [0, duration]).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch


def decode(cls_logits: Sequence[torch.Tensor], offsets: Sequence[torch.Tensor],
           masks: Sequence[torch.Tensor], points: Sequence[torch.Tensor], *,
           pre_nms_thresh: float, pre_nms_topk: int, duration_thresh: float):
    """(segs (B, K, 2), scores (B, K), cls (B, K), valid (B, K)) of the
    per-level top-k candidates, ties keeping the lower index first."""
    segs_all, scores_all, cls_all, valid_all = [], [], [], []
    for cls_i, off_i, mask_i, pts_i in zip(cls_logits, offsets, masks, points):
        b, t_l, c = cls_i.shape
        flat = (torch.sigmoid(cls_i) * mask_i[..., None].float()).reshape(b, -1)
        k = min(pre_nms_topk, t_l * c)
        if k == t_l * c:
            top_p = flat
            top_idx = torch.arange(t_l * c, device=flat.device).expand(b, -1)
        else:
            top_p, top_idx = torch.sort(flat, dim=1, descending=True, stable=True)
            top_p, top_idx = top_p[:, :k], top_idx[:, :k]
        off = off_i.reshape(b, t_l * c, 2).gather(1, top_idx[..., None].expand(-1, -1, 2))
        pts = pts_i[top_idx // c]
        left = pts[..., 0] - off[..., 0] * pts[..., 3]
        right = pts[..., 0] + off[..., 1] * pts[..., 3]
        segs_all.append(torch.stack([left, right], dim=-1))
        scores_all.append(top_p)
        cls_all.append(top_idx % c)
        valid_all.append((top_p > pre_nms_thresh) & ((right - left) > duration_thresh))
    return (torch.cat(segs_all, 1), torch.cat(scores_all, 1), torch.cat(cls_all, 1),
            torch.cat(valid_all, 1))


def candidates(cls_logits, offsets, masks, points, *, pre_nms_thresh: float,
               pre_nms_topk: int, duration_thresh: float, tol: float):
    """The candidates that `decode` keeps, widened by those that a rounding of
    relative size `tol` could bring in: (segs, scores, cls, required,
    included), (B, K') each. `required` holds what decode keeps with a
    margin of `tol` from the per-level top-k cut, the score threshold and
    the minimum duration; `included` adds the candidates within that margin
    (either side may keep them)."""
    segs_all, scores_all, cls_all, req_all, inc_all = [], [], [], [], []
    for cls_i, off_i, mask_i, pts_i in zip(cls_logits, offsets, masks, points):
        b, t_l, c = cls_i.shape
        flat = (torch.sigmoid(cls_i) * mask_i[..., None].float()).reshape(b, -1)
        srt, idx = torch.sort(flat, dim=1, descending=True, stable=True)
        k = min(pre_nms_topk, t_l * c)
        if k < t_l * c:
            cut = srt[:, k - 1:k]
            keep = srt >= cut * (1.0 - tol)
            req = (torch.arange(t_l * c, device=flat.device)[None, :] < k) & (srt > cut * (1.0 + tol))
        else:
            keep = torch.ones_like(srt, dtype=torch.bool)
            req = keep
        n = int(keep.sum(1).max())
        srt, idx, keep, req = srt[:, :n], idx[:, :n], keep[:, :n], req[:, :n]
        off = off_i.reshape(b, t_l * c, 2).gather(1, idx[..., None].expand(-1, -1, 2))
        pts = pts_i[idx // c]
        left = pts[..., 0] - off[..., 0] * pts[..., 3]
        right = pts[..., 0] + off[..., 1] * pts[..., 3]
        dur = right - left
        inc = keep & (srt > pre_nms_thresh * (1.0 - tol)) & (dur > duration_thresh - tol)
        req = req & (srt > pre_nms_thresh * (1.0 + tol)) & (dur > duration_thresh + tol)
        segs_all.append(torch.stack([left, right], dim=-1))
        scores_all.append(srt)
        cls_all.append(idx % c)
        req_all.append(req)
        inc_all.append(inc)
    return (torch.cat(segs_all, 1), torch.cat(scores_all, 1), torch.cat(cls_all, 1),
            torch.cat(req_all, 1), torch.cat(inc_all, 1))


def to_seconds(segs, batch):
    """Grid units to seconds, clamped to [0, duration]."""
    stride, frames = batch["feat_stride"].float(), batch["feat_num_frames"].float()
    fps, duration = batch["fps"].float(), batch["duration"].float()
    segs = (segs * stride[:, None, None] + 0.5 * frames[:, None, None]) / fps[:, None, None]
    return torch.minimum(segs.clamp(min=0.0), duration[:, None, None])


def multiclass_soft_nms(segs, scores, cls, valid, *, max_out: int, sigma: float,
                        min_score: float):
    """Per-class Gaussian Soft-NMS of each row as one select-and-decay scan:
    each step emits the first maximum with its current score, decays the
    same class by exp(-iou^2 / sigma), kills same-class lanes below
    min_score and the emitted lane. Returns (segs, scores, cls, valid) of
    max_out slots in emission order, empty slots 0 / False."""
    g, n = scores.shape
    k_out = min(max_out, n)
    s = torch.where(valid, scores.float(), float("-inf"))
    x1, x2 = segs[..., 0].float(), segs[..., 1].float()
    cls = cls.long()
    lane = torch.arange(n, device=s.device)[None, :]
    out_idx = torch.zeros((g, max_out), dtype=torch.long, device=s.device)
    out_score = torch.zeros((g, max_out), dtype=torch.float32, device=s.device)
    out_ok = torch.zeros((g, max_out), dtype=torch.bool, device=s.device)
    for k in range(k_out):
        j = s.argmax(dim=1, keepdim=True)
        smax = s.gather(1, j)
        alive = smax > float("-inf")
        out_idx[:, k] = torch.where(alive, j, 0)[:, 0]
        out_score[:, k] = torch.where(alive, smax, 0.0)[:, 0]
        out_ok[:, k] = alive[:, 0]
        sx1, sx2 = x1.gather(1, j), x2.gather(1, j)
        inter = (torch.minimum(sx2, x2) - torch.maximum(sx1, x1)).clamp(min=0.0)
        iou = inter / ((sx2 - sx1 + 1e-6) + (x2 - x1 + 1e-6) - inter)
        w = torch.exp(-(iou * iou) / sigma)
        same = cls == cls.gather(1, j)
        low = same & (s * w < min_score)
        w = torch.where(same, w, 1.0)
        kill = low | (lane == j) | (s == float("-inf"))
        s = torch.where(alive, (s * w).masked_fill(kill, float("-inf")), s)
    return (segs.gather(1, out_idx[..., None].expand(-1, -1, 2)), out_score,
            cls.gather(1, out_idx), out_ok)


def detections(out: Dict, points: Sequence[torch.Tensor], batch: Dict, test_cfg: Dict):
    """The eval protocol's detections of a forward's outputs: segments
    (B, M, 2) in seconds, scores, labels, valid (B, M)."""
    segs, scores, cls, valid = decode(
        out["cls_logits"], out["offsets"], out["masks"], points,
        pre_nms_thresh=test_cfg["pre_nms_thresh"], pre_nms_topk=test_cfg["pre_nms_topk"],
        duration_thresh=test_cfg["duration_thresh"])
    segs, scores, cls, valid = multiclass_soft_nms(
        segs, scores, cls, valid, max_out=test_cfg["max_seg_num"],
        sigma=test_cfg["nms_sigma"], min_score=test_cfg["min_score"])
    return {"segments": to_seconds(segs, batch), "scores": scores, "labels": cls,
            "valid": valid}
