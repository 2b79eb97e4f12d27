"""FCOS-1D label assignment and per-frame auxiliary targets for a batch, on
the device, with fixed shapes (ground-truth events padded to N with a
validity mask).

  * `assign_labels_batch`: center-sampling point label assignment; with
    class_aware the LAST matching event of each class (in annotation order)
    gives the regression target, as the reference's scatter loop does.
  * `frame_targets_batch`: the per-frame score / start-end / class targets
    of the reference collate, with its grid/1.28 divisor quirk.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# The reference collate divides segment *grid* coordinates by 1.28 when
# building per-frame targets ("each 1.28 seconds is one feature", though the
# values are feature-grid units, not seconds). Kept as it is.
FRAME_TARGET_DIVISOR = 1.28


def assign_labels_batch(points: torch.Tensor, gt_segments: torch.Tensor,
                        gt_labels: torch.Tensor, gt_valid: torch.Tensor,
                        num_classes: int, class_aware: bool = True):
    """points (P, 4) rows (t, reg_lo, reg_hi, stride); gt_segments (B, N, 2)
    in feature-grid units, gt_labels (B, N) int, gt_valid (B, N) bool.
    Returns cls_targets (B, P, C) multi-hot and reg_targets (B, P, C, 2)
    (class_aware) or (B, P, 2), normalized by the point's stride."""
    t = points[:, 0][None, :, None]                        # (1, P, 1)
    seg = gt_segments.float()
    left = t - seg[:, None, :, 0]                          # (B, P, N)
    right = seg[:, None, :, 1] - t
    # inside the event on both sides, inclusive per-level regression range
    max_dist = torch.maximum(left, right)
    ok = ((torch.minimum(left, right) > 0)
          & (max_dist >= points[:, 1][None, :, None])
          & (max_dist <= points[:, 2][None, :, None])
          & gt_valid[:, None, :])
    lens = (seg[..., 1] - seg[..., 0])[:, None, :].expand_as(left)
    lens = torch.where(ok, lens, torch.full_like(lens, float("inf")))
    one_hot = F.one_hot(gt_labels.long(), num_classes).float() \
        * gt_valid[..., None].float()                      # (B, N, C)
    stride = points[:, 3][None, :, None]

    if class_aware:
        cls_targets = ((lens < float("inf")).float() @ one_hot).clamp(0.0, 1.0)
        # per (point, class): the last matching event of that class, or -1
        n = seg.shape[1]
        idx_ok = torch.where(ok, torch.arange(n, device=seg.device)[None, None, :],
                             torch.full_like(ok, -1, dtype=torch.long))
        j_star = torch.full(cls_targets.shape, -1, dtype=torch.long, device=seg.device)
        j_star = j_star.scatter_reduce(2, gt_labels.long()[:, None, :].expand_as(idx_ok),
                                       idx_ok, reduce="amax")
        has = j_star >= 0
        sel = seg[torch.arange(seg.shape[0], device=seg.device)[:, None, None],
                  j_star.clamp(min=0)]                     # (B, P, C, 2)
        reg = torch.stack([t - sel[..., 0], sel[..., 1] - t], dim=-1)
        return cls_targets, reg * has[..., None].float() / stride[..., None]

    # shortest matching event; the first of equal minima, as torch.min
    min_len, min_idx = lens.min(dim=2)
    min_len_mask = ((lens <= min_len[..., None] + 1e-3) & (lens < float("inf"))).float()
    cls_targets = (min_len_mask @ one_hot).clamp(0.0, 1.0)
    reg = torch.stack([left, right], dim=-1).gather(
        2, min_idx[..., None, None].expand(-1, -1, 1, 2))[:, :, 0]
    return cls_targets, reg / stride


def frame_targets_batch(gt_segments: torch.Tensor, gt_labels: torch.Tensor,
                        gt_valid: torch.Tensor, seq_len: int, num_classes: int):
    """Per-frame targets (B, T) scores, (B, T) start_end, (B, T, C) labels:
    scores[t] = 1 where start <= t < end of a valid event, start_end[t] = 1
    where start <= t <= end, labels[t] the one-hot of the last event (in
    annotation order) with start <= t < end; start/end = trunc(grid / 1.28),
    negative starts clamped to 0."""
    start = torch.trunc(gt_segments[..., 0].float() / FRAME_TARGET_DIVISOR).int().clamp(min=0)
    end = torch.trunc(gt_segments[..., 1].float() / FRAME_TARGET_DIVISOR).int()
    t = torch.arange(seq_len, device=gt_segments.device, dtype=torch.int32)[None, :, None]
    valid = gt_valid[:, None, :]
    after_start = t >= start[:, None, :]
    in_score = after_start & (t < end[:, None, :]) & valid     # (B, T, N)
    in_se = after_start & (t <= end[:, None, :]) & valid
    n = gt_segments.shape[1]
    seg_idx = torch.where(in_score, torch.arange(n, device=gt_segments.device),
                          torch.full_like(in_score, -1, dtype=torch.long))
    j_star = seg_idx.amax(dim=2)                               # (B, T)
    labels = gt_labels.long().gather(1, j_star.clamp(min=0))
    labels = F.one_hot(labels, num_classes).float() * (j_star >= 0)[..., None].float()
    return in_score.any(dim=2).float(), in_se.any(dim=2).float(), labels
