"""Whole-batch multiclass Soft-NMS around the merged-scan kernel.

`batched_nms`, `soft_nms_fixed`, `hard_nms_fixed` and `seg_voting` of the
JAX package are not ported yet: the eval protocol (Gaussian Soft-NMS,
multiclass) does not reach them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .fused_nms import multiclass_soft_nms


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
    out = (segs.gather(1, idx[..., None].expand(-1, -1, 2)), sc,
           cls_idxs.gather(1, idx), ok)
    pad = max_seg_num - k
    if pad:
        out = tuple(torch.cat([o, o.new_zeros((o.shape[0], pad) + o.shape[2:])], 1)
                    for o in out)
    return out
