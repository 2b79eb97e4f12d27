"""Losses the eval forward reports. The detection losses wait for the
train path."""

from __future__ import annotations

import torch


def focal_loss_score(pred: torch.Tensor, target: torch.Tensor,
                     weights: torch.Tensor, alpha: float = 0.25,
                     gamma: float = 2.0) -> torch.Tensor:
    """Weighted sum of the binary focal loss on per-frame foreground
    scores, in the direct -alpha_t (1-p_t)^g log(clamp(p_t, 1e-7)) form of
    the reference."""
    p = torch.sigmoid(pred.float())
    t = target.float()
    p_t = p * t + (1.0 - p) * (1.0 - t)
    alpha_t = alpha * t + (1.0 - alpha) * (1.0 - t)
    loss = -alpha_t * (1.0 - p_t) ** gamma * torch.log(p_t.clamp(min=1e-7))
    return (loss * weights).sum()
