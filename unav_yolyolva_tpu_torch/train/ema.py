"""EMA of the model parameters: e <- decay * e + (1 - decay) * p after every
optimizer step (the reference's ModelEma, decay 0.999). The detector has no
buffers, so the parameters are its whole state."""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def ema_update(ema: nn.Module, model: nn.Module, decay: float = 0.999) -> None:
    """Update the EMA copy `ema` of `model` in place."""
    e = list(ema.parameters())
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, list(model.parameters()), alpha=1.0 - decay)
