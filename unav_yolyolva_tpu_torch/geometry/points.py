"""Temporal point (anchor) grids: per level, rows (t, reg_lo, reg_hi, stride)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def pyramid_strides(scale_factor: int, num_levels: int) -> List[int]:
    return [scale_factor ** i for i in range(num_levels)]


def eval_seq_len(feat_len: int, max_seq_len: int, max_div_factor: int) -> int:
    """Padded sequence length at eval time: lengths up to max_seq_len pad to
    max_seq_len; longer ones round up to the next multiple of the largest
    pyramid stride."""
    if feat_len <= max_seq_len:
        return max_seq_len
    return (feat_len + max_div_factor - 1) // max_div_factor * max_div_factor


def generate_points(seq_len: int, regression_range: Sequence[Tuple[float, float]],
                    scale_factor: int = 2) -> List[np.ndarray]:
    """Per-level float32 (T_l, 4) point grids with T_l = seq_len / stride_l."""
    out = []
    for level, stride in enumerate(pyramid_strides(scale_factor, len(regression_range))):
        assert seq_len % stride == 0, f"seq_len {seq_len} not divisible by stride {stride}"
        t = np.arange(0, seq_len, stride, dtype=np.float32)
        lo, hi = regression_range[level]
        out.append(np.stack([t, np.full_like(t, lo), np.full_like(t, hi),
                             np.full_like(t, stride)], axis=1))
    return out


def concat_points(points: List[np.ndarray]) -> np.ndarray:
    """Per-level points as one (P, 4) array."""
    return np.concatenate(points, axis=0)

