"""Classification and regression towers shared over the pyramid levels.

Run level by level; the JAX package's level-packed form is proven equal to
this loop to the last ULP (tests/test_packed_heads.py). Under the bf16
policy (`dtype`) the towers compute in bf16 and the final cls / offset
convs in fp32 on the promoted tower output, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import ChannelLayerNorm, LearnableScale, MaskedConv1D


def cls_prior_bias(prior_prob: float, num_classes: int,
                   empty_cls: Sequence[int]) -> torch.Tensor:
    """Focal prior bias, empty classes pinned hard negative."""
    b = torch.full((num_classes,), -math.log((1 - prior_prob) / prior_prob))
    for idx in empty_cls:
        b[idx] = -math.log((1 - 1e-6) / 1e-6)
    return b


class ConvTower(nn.Module):
    """(num_layers - 1) x [MaskedConv1D + (LN) + ReLU], named head.i/norm.i
    as in the reference."""

    def __init__(self, input_dim: int, feat_dim: int, num_layers: int,
                 kernel_size: int, with_ln: bool, dtype: Optional[torch.dtype] = None):
        super().__init__()
        dims = [input_dim] + [feat_dim] * (num_layers - 1)
        self.head = nn.ModuleList([
            MaskedConv1D(dims[i], feat_dim, kernel_size, bias=not with_ln, dtype=dtype)
            for i in range(num_layers - 1)])
        self.norm = nn.ModuleList([
            ChannelLayerNorm(feat_dim, dtype=dtype) if with_ln else nn.Identity()
            for _ in range(num_layers - 1)])
        self.out_dim = dims[-1]

    def tower(self, x, mask):
        for conv, norm in zip(self.head, self.norm):
            x, _ = conv(x, mask)
            x = F.relu(norm(x))
        return x


class ClsHead(ConvTower):
    def __init__(self, input_dim: int, feat_dim: int, num_classes: int,
                 prior_prob: float = 0.01, num_layers: int = 3,
                 kernel_size: int = 3, with_ln: bool = True,
                 empty_cls: Sequence[int] = (), dtype: Optional[torch.dtype] = None):
        super().__init__(input_dim, feat_dim, num_layers, kernel_size, with_ln, dtype)
        self.prior_prob, self.empty_cls = prior_prob, tuple(empty_cls)
        self.cls_head = MaskedConv1D(self.out_dim, num_classes, kernel_size)

    def forward(self, feats: List[torch.Tensor], masks: List[torch.Tensor]):
        return [self.cls_head(self.tower(f, m), m)[0] for f, m in zip(feats, masks)]


class RegHead(ConvTower):
    def __init__(self, input_dim: int, feat_dim: int, num_classes: int,
                 fpn_levels: int, num_layers: int = 3, kernel_size: int = 3,
                 with_ln: bool = True, class_aware: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(input_dim, feat_dim, num_layers, kernel_size, with_ln, dtype)
        out_dim = 2 * num_classes if class_aware else 2
        self.offset_head = MaskedConv1D(self.out_dim, out_dim, kernel_size)
        self.scale = nn.ModuleList([LearnableScale() for _ in range(fpn_levels)])

    def forward(self, feats: List[torch.Tensor], masks: List[torch.Tensor]):
        return [F.relu(scale(self.offset_head(self.tower(f, m), m)[0]))
                for scale, f, m in zip(self.scale, feats, masks)]
