"""In-memory synthetic batches shaped like the collated UnAV-100 features
(I3D rgb+flow visual, VGGish audio), made from a generator: eval batches,
and train batches with padded ground-truth events."""

from __future__ import annotations

from typing import Dict

import torch


def synthetic_eval_batch(gen: torch.Generator, batch: int, seq_len: int,
                         dim_v: int = 2048, dim_a: int = 128,
                         feat_stride: float = 8.0, num_frames: float = 24.0,
                         fps: float = 25.0) -> Dict[str, torch.Tensor]:
    """A batch for make_eval_step: valid lengths drawn in [16, seq_len]
    (the first video full, the last a zero-padded row with no frame, as the
    eval collate pads a final partial batch), features zero past each
    length, duration matching the length."""
    lengths = torch.randint(16, seq_len + 1, (batch,), generator=gen)
    lengths[0] = seq_len
    lengths[-1] = 0
    mask = torch.arange(seq_len)[None, :] < lengths[:, None]
    m = mask[..., None].float()
    return {
        "visual": torch.randn(batch, seq_len, dim_v, generator=gen) * m,
        "audio": torch.randn(batch, seq_len, dim_a, generator=gen) * m,
        "mask": mask,
        "fps": torch.full((batch,), fps),
        "duration": lengths.float() * feat_stride / fps,
        "feat_stride": torch.full((batch,), feat_stride),
        "feat_num_frames": torch.full((batch,), num_frames),
    }


def synthetic_train_batch(gen: torch.Generator, batch: int, seq_len: int,
                          dim_v: int = 2048, dim_a: int = 128, num_classes: int = 100,
                          max_num_events: int = 64) -> Dict[str, torch.Tensor]:
    """A batch for make_train_step: valid lengths drawn in [16, seq_len]
    (the first video full; train rows are never all padding), features zero
    past each length, and 1..4 events per video inside its valid
    frames (feature-grid units, width >= 1), padded to max_num_events with
    gt_valid False, as the train collate pads them."""
    lengths = torch.randint(16, seq_len + 1, (batch,), generator=gen)
    lengths[0] = seq_len
    mask = torch.arange(seq_len)[None, :] < lengths[:, None]
    m = mask[..., None].float()
    n_events = torch.randint(1, min(4, max_num_events) + 1, (batch,), generator=gen)
    gt_valid = torch.arange(max_num_events)[None, :] < n_events[:, None]
    span = lengths[:, None].float()
    start = torch.rand(batch, max_num_events, generator=gen) * (span - 1.0)
    width = 1.0 + torch.rand(batch, max_num_events, generator=gen) * (span / 2.0)
    segs = torch.stack([start, torch.minimum(start + width, span)], dim=-1)
    return {
        "visual": torch.randn(batch, seq_len, dim_v, generator=gen) * m,
        "audio": torch.randn(batch, seq_len, dim_a, generator=gen) * m,
        "mask": mask,
        "gt_segments": segs * gt_valid[..., None],
        "gt_labels": torch.randint(0, num_classes, (batch, max_num_events),
                                   generator=gen) * gt_valid,
        "gt_valid": gt_valid,
    }
