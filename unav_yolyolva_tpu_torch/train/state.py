"""Train state: everything a train step changes, in one place (the model,
its optimizer, the EMA copy, the loss-normalizer EMA and the step count)."""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch
from torch import nn

from .optim import ClippedOptimizer


@dataclass
class TrainState:
    model: nn.Module
    optimizer: ClippedOptimizer
    ema: nn.Module
    loss_normalizer: torch.Tensor   # scalar fp32 EMA of the positive count
    step: int = 0


def create_train_state(model: nn.Module, optimizer: ClippedOptimizer,
                       init_loss_norm: float) -> TrainState:
    """A state at step 0 whose EMA copy starts at the model's weights.

    Data parallel: every rank builds its model from the same seed
    (models/meta_arch.py:build_model draws on the CPU), so the states agree
    with no communication, as every JAX process computes the same init."""
    ema = copy.deepcopy(model).eval().requires_grad_(False)
    dev = next(model.parameters()).device
    return TrainState(model, optimizer, ema,
                      torch.tensor(float(init_loss_norm), device=dev))
