"""Proposal decoding and postprocessing for a whole batch.

The JAX package decodes one video and vmaps it; here the batch dimension is
written out. Per level: sigmoid scores masked by the frame mask, top-k over
(T_l x C) (skipped when k covers every candidate), threshold, offset decode
against the point grid and a minimum-duration filter; optionally a cap of
the concatenated candidates to the global top by score
(`tpu.nms_max_candidates`). Then (Soft-)NMS and the grid -> seconds
conversion with a clamp to [0, duration].
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from ..ops import nms as nms_ops


def decode_batch(
    cls_logits: Sequence[torch.Tensor],   # levels x (B, T_l, C)
    offsets: Sequence[torch.Tensor],      # levels x (B, T_l, C, 2) or (B, T_l, 2)
    masks: Sequence[torch.Tensor],        # levels x (B, T_l)
    points: Sequence[torch.Tensor],       # levels x (T_l, 4)
    *,
    pre_nms_thresh: float,
    pre_nms_topk: int,
    duration_thresh: float,
    class_aware: bool,
    max_candidates: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The JAX package's decode_single_video over the whole batch: (segs
    (B, K, 2), scores (B, K), cls (B, K), valid (B, K)) with K = sum over
    levels of min(pre_nms_topk, T_l * C). With 0 < max_candidates < K the
    concatenation is cut to the top max_candidates by score, invalid
    candidates ranked at -1 (it bounds the NMS scan; 0 keeps the reference
    candidate set). Ties in either top-k keep the lower index first, as
    lax.top_k does."""
    segs_all, scores_all, cls_all, valid_all = [], [], [], []
    for cls_i, off_i, mask_i, pts_i in zip(cls_logits, offsets, masks, points):
        b, t_l, c = cls_i.shape
        flat = (torch.sigmoid(cls_i) * mask_i[..., None].to(cls_i.dtype)).reshape(b, -1)
        k = min(pre_nms_topk, t_l * c)
        if k == t_l * c:
            # every candidate: no sort (Soft-NMS picks by score, and its
            # emissions come out in score order)
            top_p = flat
            top_idx = torch.arange(t_l * c, device=flat.device).expand(b, -1)
        else:
            top_p, top_idx = torch.sort(flat, dim=1, descending=True, stable=True)
            top_p, top_idx = top_p[:, :k], top_idx[:, :k]
        pt_idx = top_idx // c
        if class_aware:
            off = off_i.reshape(b, t_l * c, 2).gather(1, top_idx[..., None].expand(-1, -1, 2))
        else:
            off = off_i.gather(1, pt_idx[..., None].expand(-1, -1, 2))
        pts = pts_i[pt_idx]                                          # (B, k, 4)
        seg_left = pts[..., 0] - off[..., 0] * pts[..., 3]
        seg_right = pts[..., 0] + off[..., 1] * pts[..., 3]
        segs_all.append(torch.stack([seg_left, seg_right], dim=-1))
        scores_all.append(top_p)
        cls_all.append(top_idx % c)
        valid_all.append((top_p > pre_nms_thresh)
                         & ((seg_right - seg_left) > duration_thresh))
    segs, scores = torch.cat(segs_all, 1), torch.cat(scores_all, 1)
    cls, valid = torch.cat(cls_all, 1).int(), torch.cat(valid_all, 1)
    if 0 < max_candidates < scores.shape[1]:
        ranked = torch.where(valid, scores, torch.full_like(scores, -1.0))
        idx = torch.sort(ranked, dim=1, descending=True, stable=True)[1][:, :max_candidates]
        segs = segs.gather(1, idx[..., None].expand(-1, -1, 2))
        scores, cls, valid = (a.gather(1, idx) for a in (scores, cls, valid))
    return segs, scores, cls, valid


def postprocess_batch(segs, scores, cls_idxs, valid, *, num_classes: int, test_cfg: Dict,
                      fps, duration, feat_stride, num_frames):
    """NMS + grid -> seconds: (seg * stride + 0.5 * nframes) / fps, clamped
    to [0, duration]. Multiclass Gaussian Soft-NMS (the eval protocol) runs
    the merged class-masked scan; hard NMS and single-class NMS (with
    segment voting) run batched_nms; "none" passes the candidates through."""
    method = test_cfg["nms_method"]
    if method not in ("soft", "hard", "none"):
        raise ValueError(f"nms_method={method!r}: expected soft, hard or none")
    if method == "soft" and test_cfg["multiclass_nms"]:
        segs, scores, cls_idxs, valid = nms_ops.multiclass_nms_batch(
            segs, scores, cls_idxs, valid,
            max_seg_num=test_cfg["max_seg_num"],
            sigma=test_cfg["nms_sigma"],
            min_score=test_cfg["min_score"],
        )
    elif method != "none":
        segs, scores, cls_idxs, valid = nms_ops.batched_nms(
            segs, scores, cls_idxs, valid,
            num_classes=num_classes,
            iou_threshold=test_cfg["iou_threshold"],
            min_score=test_cfg["min_score"],
            max_seg_num=test_cfg["max_seg_num"],
            use_soft_nms=method == "soft",
            multiclass=test_cfg["multiclass_nms"],
            sigma=test_cfg["nms_sigma"],
            voting_thresh=test_cfg["voting_thresh"],
            method=nms_ops.NMS_GAUSSIAN,
        )
    segs = (segs * feat_stride[:, None, None] + 0.5 * num_frames[:, None, None]) \
        / fps[:, None, None]
    segs = torch.minimum(segs.clamp(min=0.0), duration[:, None, None])
    return segs, scores, cls_idxs, valid
