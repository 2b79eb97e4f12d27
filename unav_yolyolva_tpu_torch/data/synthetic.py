"""In-memory synthetic eval batches shaped like the collated UnAV-100
features (I3D rgb+flow visual, VGGish audio), made from a generator."""

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
