"""Whole-batch 1D (Soft-)NMS around the scan kernels of ops/fused_nms.py.

Ports the JAX package's ops/nms.py with the batch axis written out:
  * `multiclass_nms_batch`: the eval protocol's multiclass Gaussian
    Soft-NMS, one merged class-masked scan per video (multiclass_soft_nms);
  * `batched_nms`: every other configuration (hard NMS, single-class with
    segment voting, and the grouped per-class form), through
    `soft_nms_fixed` / `hard_nms_fixed`, whose G independent rows (a
    video's per-class buffers stacked over the batch, G = B * C, or one row
    per video) go to one `soft_nms` launch;
  * `group_by_class` (dense per-class top-m buffers by two stable sorts)
    and `seg_voting` (an (M, N) weighted average, plain torch: no TPU kernel
    computes it).
Dead candidates are -inf scores in the kernels; a slot with nothing left
gives index -1 there and 0 here, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .fused_nms import NMS_GAUSSIAN, NMS_HARD, multiclass_soft_nms, soft_nms

# the least positive float32: the kill threshold that makes method 0 drop
# suppressed (zero-score) lanes when the caller's min_score is <= 0
_LEAST_POSITIVE = math.ldexp(1.0, -149)

Tensors = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _pad_slots(out, width: int):
    """Zero-pad the slot axis (axis 1) of each (G, k, ...) tensor to `width`."""
    pad = width - out[0].shape[1]
    if not pad:
        return tuple(out)
    return tuple(torch.cat([o, o.new_zeros((o.shape[0], pad) + o.shape[2:])], 1) for o in out)


def soft_nms_fixed(segs, scores, alive0, max_out: int, iou_threshold: float, sigma: float,
                   min_score: float, method: int = NMS_GAUSSIAN) -> Tensors:
    """Soft-NMS over G fixed candidate rows: segs (G, N, 2), scores (G, N),
    alive0 (G, N) bool. Returns (idx (G, max_out) int64, score, valid); the
    scan runs min(max_out, N) steps and later slots are 0 / 0 / False."""
    k = min(max_out, segs.shape[1])
    idx, sc, ok = soft_nms(segs, torch.where(alive0, scores.float(), float("-inf")),
                           max_out=k, iou_threshold=iou_threshold, sigma=sigma,
                           min_score=min_score, method=method)
    return _pad_slots((idx.long().clamp(min=0), sc, ok), max_out)


def hard_nms_fixed(segs, scores, alive0, max_out: int, iou_threshold: float,
                   min_score: float) -> Tensors:
    """Greedy hard NMS: scores never decay, lanes at IoU >= iou_threshold
    with an emission die, and a min_score > 0 prefilters scores > min_score.
    That is the method-0 scan after the prefilter; with min_score <= 0 the
    scan kills at the least positive float instead, which drops the
    suppressed lanes (score 0) and is exact for positive scores (the
    decoder's scores are sigmoids above pre_nms_thresh)."""
    if min_score > 0:
        alive0 = alive0 & (scores > min_score)
    return soft_nms_fixed(segs, scores, alive0, max_out, iou_threshold, 1.0,
                          max(min_score, _LEAST_POSITIVE), NMS_HARD)


def seg_voting(nms_segs, nms_valid, all_segs, all_scores, all_valid,
               iou_threshold: float) -> torch.Tensor:
    """Segment voting of (B, M, 2) kept segments against all (B, N, 2)
    candidates: each valid kept segment becomes the score-weighted mean of
    the candidates at IoU >= iou_threshold with it (the reference weights
    by the raw scores)."""
    left = torch.maximum(nms_segs[:, :, None, 0], all_segs[:, None, :, 0])
    right = torch.minimum(nms_segs[:, :, None, 1], all_segs[:, None, :, 1])
    inter = (right - left).clamp(min=0.0)
    lens_n = nms_segs[..., 1] - nms_segs[..., 0]
    lens_a = all_segs[..., 1] - all_segs[..., 0]
    iou = inter / (lens_n[:, :, None] + lens_a[:, None, :] - inter)
    w = (iou >= iou_threshold).float() * (all_scores * all_valid.float())[:, None, :]
    w = w / w.sum(dim=2, keepdim=True).clamp(min=1e-12)
    return torch.where(nms_valid[..., None], torch.bmm(w, all_segs), nms_segs)


def group_by_class(segs, scores, cls_idxs, valid, num_classes: int, m: int) -> Tensors:
    """Dense per-class top-m candidate buffers of each video: (buf_segs
    (B, C, m, 2), buf_scores (B, C, m) with -inf for empty slots, buf_idx
    (B, C, m) candidate indices, 0 for empty slots). Within a class the
    order is score descending, then index ascending (two stable sorts);
    candidates past the top m are dropped."""
    b, n = scores.shape
    cls_key = torch.where(valid, cls_idxs.long(), num_classes)
    neg_sc = torch.where(valid, -scores.float(), float("inf"))
    by_score = torch.sort(neg_sc, dim=1, stable=True).indices
    by_class = torch.sort(cls_key.gather(1, by_score), dim=1, stable=True).indices
    order = by_score.gather(1, by_class)
    srt_cls, srt_neg = cls_key.gather(1, order), neg_sc.gather(1, order)
    bounds = torch.arange(num_classes + 1, device=scores.device).expand(b, -1).contiguous()
    first = torch.searchsorted(srt_cls.contiguous(), bounds, side="left")   # (B, C + 1)
    span = first[:, :-1, None] + torch.arange(m, device=scores.device)       # (B, C, m)
    in_class = span < first[:, 1:, None]
    span_c = span.clamp(max=n - 1).reshape(b, -1)
    buf_scores = torch.where(in_class, -srt_neg.gather(1, span_c).view(b, num_classes, m),
                             float("-inf"))
    buf_idx = torch.where(in_class, order.gather(1, span_c).view(b, num_classes, m), 0)
    buf_segs = segs.gather(1, buf_idx.reshape(b, -1, 1).expand(-1, -1, 2))
    return buf_segs.view(b, num_classes, m, 2), buf_scores, buf_idx


def multiclass_nms_batch(
    segs: torch.Tensor,      # (B, N, 2)
    scores: torch.Tensor,    # (B, N)
    cls_idxs: torch.Tensor,  # (B, N)
    valid: torch.Tensor,     # (B, N) bool
    *,
    max_seg_num: int,
    sigma: float,
    min_score: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact per-class Gaussian Soft-NMS of every video of a batch through
    the merged class-masked scan (the IoU threshold does not enter the
    Gaussian weight). Returns (segs (B, M, 2), scores (B, M), cls (B, M),
    valid (B, M)) with M = max_seg_num, in descending-score order."""
    n = segs.shape[1]
    k = min(max_seg_num, n)
    idx, sc, ok = multiclass_soft_nms(
        segs, torch.where(valid, scores, float("-inf")), cls_idxs,
        max_out=k, sigma=sigma, min_score=min_score,
    )
    idx = idx.long().clamp(min=0)
    return _pad_slots((segs.gather(1, idx[..., None].expand(-1, -1, 2)), sc,
                       cls_idxs.gather(1, idx), ok), max_seg_num)


def batched_nms(
    segs: torch.Tensor,      # (B, N, 2) candidate segments (feature-grid units)
    scores: torch.Tensor,    # (B, N)
    cls_idxs: torch.Tensor,  # (B, N)
    valid: torch.Tensor,     # (B, N) bool
    *,
    num_classes: int,
    iou_threshold: float,
    min_score: float,
    max_seg_num: int,
    use_soft_nms: bool = True,
    multiclass: bool = True,
    sigma: float = 0.5,
    voting_thresh: float = 0.75,
    method: int = NMS_GAUSSIAN,
    per_class_topk: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX package's batched_nms for every video of a batch: (segs
    (B, M, 2), scores (B, M), cls (B, M), valid (B, M)) with M =
    max_seg_num, sorted by descending score (ties: emission order).
    Multiclass runs each class on its own row: the class's top
    `per_class_topk` candidates (group_by_class) when that is fewer than N,
    else all N candidates with the other classes dead. Single-class runs one
    row per video, then segment voting when voting_thresh > 0."""
    b, n = scores.shape

    def run(r_segs, r_scores, alive0, seg_count):
        k = min(max_seg_num, seg_count)
        if use_soft_nms:
            return soft_nms_fixed(r_segs, r_scores, alive0, k, iou_threshold, sigma,
                                  min_score, method)
        return hard_nms_fixed(r_segs, r_scores, alive0, k, iou_threshold, min_score)

    if multiclass:
        c = num_classes
        if 0 < per_class_topk < n:
            m = per_class_topk
            sub_segs, sub_scores, sub_idx = group_by_class(segs, scores, cls_idxs, valid, c, m)
            alive = sub_scores > float("-inf")
            lidx, sc, ok = run(sub_segs.reshape(b * c, m, 2),
                               torch.where(alive, sub_scores, 0.0).reshape(b * c, m),
                               alive.reshape(b * c, m), m)
            idx = sub_idx.reshape(b * c, m).gather(1, lidx)
        else:
            alive = valid[:, None, :] & (cls_idxs.long()[:, None, :]
                                         == torch.arange(c, device=segs.device)[None, :, None])
            idx, sc, ok = run(segs[:, None].expand(b, c, n, 2).reshape(b * c, n, 2),
                              scores[:, None].expand(b, c, n).reshape(b * c, n),
                              alive.reshape(b * c, n), n)
        idx, sc, ok = idx.reshape(b, -1), sc.reshape(b, -1), ok.reshape(b, -1)
        out_segs = segs.gather(1, idx[..., None].expand(-1, -1, 2))
    else:
        idx, sc, ok = run(segs, scores, valid, n)
        out_segs = segs.gather(1, idx[..., None].expand(-1, -1, 2))
        if voting_thresh > 0:
            out_segs = seg_voting(out_segs, ok, segs, scores, valid, voting_thresh)
    out_cls = cls_idxs.gather(1, idx)

    # global sort by score, cap at max_seg_num (padded if fewer candidates)
    ranked = torch.where(ok, sc, float("-inf"))
    k = min(max_seg_num, ranked.shape[1])
    top_sc, top_i = torch.sort(ranked, dim=1, descending=True, stable=True)
    top_sc, top_i = top_sc[:, :k], top_i[:, :k]
    kept = top_sc > float("-inf")
    return _pad_slots((out_segs.gather(1, top_i[..., None].expand(-1, -1, 2)),
                       torch.where(kept, top_sc, 0.0), out_cls.gather(1, top_i), kept),
                      max_seg_num)
