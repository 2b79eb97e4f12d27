"""Detection and auxiliary losses, elementwise with validity weights and one
sum, as in the JAX package (no boolean gathers, so shapes stay fixed)."""

from __future__ import annotations

from typing import Optional

import torch


def _reduce(loss: torch.Tensor, weights: Optional[torch.Tensor], reduction: str):
    if weights is not None:
        loss = loss * weights
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        if weights is not None:
            return loss.sum() / weights.sum().clamp(min=1.0)
        return loss.mean()
    return loss


def sigmoid_focal_loss(inputs: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0, reduction: str = "none",
                       weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RetinaNet focal loss on logits (BCE-with-logits form)."""
    inputs, targets = inputs.float(), targets.float()
    p = torch.sigmoid(inputs)
    ce = inputs.clamp(min=0.0) - inputs * targets + torch.log1p(torch.exp(-inputs.abs()))
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * loss
    return _reduce(loss, weights, reduction)


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


def ctr_diou_loss_1d(input_offsets: torch.Tensor, target_offsets: torch.Tensor,
                     reduction: str = "none", weights: Optional[torch.Tensor] = None,
                     eps: float = 1e-8) -> torch.Tensor:
    """1D Distance-IoU of (left, right) center offsets."""
    lp, rp = input_offsets[..., 0].float(), input_offsets[..., 1].float()
    lg, rg = target_offsets[..., 0].float(), target_offsets[..., 1].float()
    lkis, rkis = torch.minimum(lp, lg), torch.minimum(rp, rg)
    intsctk = rkis + lkis
    unionk = (lp + rp) + (lg + rg) - intsctk
    iouk = intsctk / unionk.clamp(min=eps)
    len_c = torch.maximum(lp, lg) + torch.maximum(rp, rg)
    rho = 0.5 * (rp - lp - rg + lg)
    loss = 1.0 - iouk + (rho / len_c.clamp(min=eps)) ** 2
    return _reduce(loss, weights, reduction)


def diou_pair_weights(target_offsets: torch.Tensor) -> torch.Tensor:
    """Class-aware validity: a pair counts when either target side is > 0."""
    return ((target_offsets[..., 0] > 0) | (target_offsets[..., 1] > 0)).float()
