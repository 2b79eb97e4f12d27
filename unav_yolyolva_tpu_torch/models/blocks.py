"""Masked sequence-modelling blocks on (B, T, C) activations.

Modules and parameters are named after the reference torch key space
(`utils/convert.py`), so their state_dict has the reference layouts:
Conv1d weights (out, in/groups, k), channel LayerNorm (1, C, 1),
AffineDropPath scale (1, C, 1). Stochastic depth is drawn only in training
mode (`nn.Module.training`, the JAX package's `train=`), from an explicit
torch.Generator that the caller passes down.

`dtype` is the JAX modules' `dtype=`: the compute dtype of a module's
products and the storage dtype of its outputs (None: fp32, the inputs
promoted to it). Parameters stay fp32 and are cast at the call
(`ops/masked.py:cast`). Under the bf16 policy a product's fp32 sum is
rounded to bf16 and its bias added in bf16, as flax's Dense and Conv add
it, and LayerNorms keep fp32 statistics.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_mhca import attend, fused_mhca
from ..ops.fused_tblock import fused_tblock
from ..ops.masked import cast, channel_layer_norm, gelu, masked_conv1d_out_mask
from ..parallel.mesh import uniform_rows

# Whole-block TransformerBlock path selector (ops/fused_tblock.py), the JAX
# package's by name and meaning: the UNAV_FUSED_TBLOCK environment variable
# is read again on each forward, the module global is the test hook. Opt-in:
# only "always" takes the fused path.
FUSED_TBLOCK = os.environ.get("UNAV_FUSED_TBLOCK", "auto")


def tblock_mode() -> str:
    """The whole-block path selector as a forward reads it now."""
    return os.environ.get("UNAV_FUSED_TBLOCK", FUSED_TBLOCK)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
          dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax nn.Dense(dtype=) over the last axis, weight (out, in): x and the
    weight cast to `dtype`, the product's fp32 sum stored in it, then the
    bias added in it; dtype None is fp32 with x promoted."""
    if dtype in (None, torch.float32):
        return F.linear(x.float(), weight, bias)
    y = F.linear(x.to(dtype), cast(weight, dtype))
    return y if bias is None else y + cast(bias, dtype)


class Conv1x1(nn.Module):
    """Pointwise Conv1d (weight (out, in, 1)) applied over the last axis of
    (..., C) activations, in `dtype` (`dense`)."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight[:, :, 0], self.bias, self.dtype)


class MaskedConv1D(nn.Module):
    """Conv1d with padding k//2 whose output is re-zeroed by the strided
    mask (every stride-th frame). The input is cast to `dtype` (None: fp32),
    as flax's Conv(dtype=) casts it; in bf16 the bias is added after the
    conv's sum is rounded."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, groups: int = 1, bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        assert kernel_size % 2 == 1
        self.stride, self.dtype = stride, dtype
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size, stride,
                              padding=kernel_size // 2, groups=groups, bias=bias)

    def forward(self, x: torch.Tensor, mask: torch.Tensor):
        dt = self.dtype or torch.float32
        x = x.to(dt).transpose(1, 2)
        if dt == torch.float32:
            y = self.conv(x)
        else:
            c = self.conv
            y = F.conv1d(x, cast(c.weight, dt), None, c.stride, c.padding, c.dilation,
                         c.groups)
            if c.bias is not None:
                y = y + cast(c.bias, dt)[:, None]
        y = y.transpose(1, 2)
        out_mask = masked_conv1d_out_mask(mask, self.stride)
        return y * out_mask[..., None].to(y.dtype), out_mask


class ChannelLayerNorm(nn.Module):
    """LayerNorm over channels, biased variance, eps 1e-5, fp32 stats,
    stored in `dtype` (None: the input's)."""

    def __init__(self, num_channels: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.empty(1, num_channels, 1))
        self.bias = nn.Parameter(torch.empty(1, num_channels, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return channel_layer_norm(x, self.weight.view(-1), self.bias.view(-1), self.eps,
                                  self.dtype)


def drop_path(x: torch.Tensor, drop_prob: float, generator) -> torch.Tensor:
    """Stochastic depth per sample: x / keep * floor(keep + U[0, 1)), one
    uniform draw per row of the batch from `generator` (a torch.Generator,
    or a parallel.mesh.RowShard: the rank's rows of the global batch's
    draw)."""
    keep = 1.0 - drop_prob
    u = uniform_rows((x.shape[0],) + (1,) * (x.ndim - 1), generator, x.device, x.dtype)
    return x / keep * torch.floor(keep + u)


class AffineDropPath(nn.Module):
    """Per-channel learnable scale, then stochastic depth in training."""

    def __init__(self, num_dim: int, drop_prob: float = 0.0):
        super().__init__()
        self.drop_prob = drop_prob
        self.scale = nn.Parameter(torch.empty(1, num_dim, 1))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x * self.scale.view(1, 1, -1)
        if self.training and self.drop_prob > 0.0:
            if generator is None:
                raise ValueError("AffineDropPath: training with drop_prob > 0 needs a "
                                 "torch.Generator")
            x = drop_path(x, self.drop_prob, generator)
        return x

    def multiplier(self, batch: int,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The branch multiplier of the fused block, (batch, 1, C): scale times
        floor(keep + u) / keep in training, with u drawn from `generator` in
        the shape, dtype and order of `forward`'s draw, so that one generator
        gives both paths the same stochastic depth."""
        f = torch.ones((batch, 1, 1), device=self.scale.device, dtype=torch.float32)
        if self.training and self.drop_prob > 0.0:
            if generator is None:
                raise ValueError("AffineDropPath: training with drop_prob > 0 needs a "
                                 "torch.Generator")
            keep = 1.0 - self.drop_prob
            u = uniform_rows(f.shape, generator, f.device, f.dtype)
            f = torch.floor(keep + u) / keep
        return self.scale.view(1, 1, -1) * f


class LearnableScale(nn.Module):
    """Scalar learnable multiplier."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale


class MaskedMHCA(nn.Module):
    """Multi-head conv attention with masking: x1 is the key/value source,
    x2 the query source. At stride 1 (every call of the live model) it runs
    the fused kernel (ops/fused_mhca.py) in `dtype` (None: x1's); strided
    forms take the plain path below, the JAX package's module path, with the
    reference's quirk of striding the q-conv by n_kv_stride.
    """

    def __init__(self, n_embd: int, n_head: int, n_qx_stride: int = 1,
                 n_kv_stride: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        assert n_embd % n_head == 0
        self.n_embd, self.n_head, self.dtype = n_embd, n_head, dtype
        self.n_qx_stride, self.n_kv_stride = n_qx_stride, n_kv_stride

        def dw(stride):
            k = stride + 1 if stride > 1 else 3
            return MaskedConv1D(n_embd, n_embd, k, stride=n_kv_stride,
                                groups=n_embd, bias=False, dtype=dtype)

        self.query_conv = dw(n_qx_stride)
        self.key_conv = dw(n_kv_stride)
        self.value_conv = dw(n_kv_stride)
        self.query_norm = ChannelLayerNorm(n_embd, dtype=dtype)
        self.key_norm = ChannelLayerNorm(n_embd, dtype=dtype)
        self.value_norm = ChannelLayerNorm(n_embd, dtype=dtype)
        self.query = Conv1x1(n_embd, n_embd, dtype=dtype)
        self.key = Conv1x1(n_embd, n_embd, dtype=dtype)
        self.value = Conv1x1(n_embd, n_embd, dtype=dtype)
        self.proj = Conv1x1(n_embd, n_embd, dtype=dtype)

    def packed_weights(self):
        """(dw (3, C, 3), lnw (3, C), lnb (3, C), w (4, C, C), b (4, C)) in
        the fused kernel's layout."""
        convs = (self.query_conv, self.key_conv, self.value_conv)
        norms = (self.query_norm, self.key_norm, self.value_norm)
        dense = (self.query, self.key, self.value, self.proj)
        return (
            torch.stack([c.conv.weight[:, 0, :] for c in convs]),
            torch.stack([n.weight.view(-1) for n in norms]),
            torch.stack([n.bias.view(-1) for n in norms]),
            torch.stack([d.weight[:, :, 0] for d in dense]),
            torch.stack([d.bias for d in dense]),
        )

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, mask: torch.Tensor):
        if self.n_qx_stride == 1 and self.n_kv_stride == 1:
            dt = self.dtype or x1.dtype
            return fused_mhca(x1.to(dt).contiguous(), x2.to(dt).contiguous(),
                              mask.contiguous(), *self.packed_weights(),
                              heads=self.n_head), mask
        q, qx_mask = self.query_conv(x2, mask)
        k, kv_mask = self.key_conv(x1, mask)
        v, _ = self.value_conv(x1, mask)
        q = self.query(self.query_norm(q))
        q = q * torch.tensor(1.0 / math.sqrt(self.n_embd // self.n_head), dtype=q.dtype)
        k = self.key(self.key_norm(k))
        v = self.value(self.value_norm(v))
        v = v * kv_mask[..., None].to(v.dtype)
        out = self.proj(attend(q, k, v, kv_mask, self.n_head))
        return out * qx_mask[..., None].to(out.dtype), qx_mask


class TransformerBlock(nn.Module):
    """Pre-LN block: MHCA + (max-pool) skip + MLP (hidden width n_hidden,
    4 * n_embd by default) with exact erf GELU, AffineDropPath scales on both
    branches when path_pdrop > 0. Under a `dtype` of bf16 the LayerNorms,
    the MHCA and the MLP compute in bf16 while the residual stream stays
    fp32 (the fp32 AffineDropPath scale promotes it, as in JAX)."""

    def __init__(self, n_embd: int, n_head: int,
                 n_ds_strides: Tuple[int, int] = (1, 1), path_pdrop: float = 0.0,
                 n_hidden: Optional[int] = None, dtype: Optional[torch.dtype] = None):
        super().__init__()
        n_hidden = n_hidden or 4 * n_embd
        self.n_ds_strides, self.dtype = tuple(n_ds_strides), dtype
        self.ln11 = ChannelLayerNorm(n_embd, dtype=dtype)
        self.ln12 = ChannelLayerNorm(n_embd, dtype=dtype)
        self.attn = MaskedMHCA(n_embd, n_head, n_qx_stride=n_ds_strides[0],
                               n_kv_stride=n_ds_strides[1], dtype=dtype)
        self.ln2 = ChannelLayerNorm(n_embd, dtype=dtype)
        # indices 0 and 3 as in the reference's Sequential(conv, GELU, drop, conv)
        self.mlp = nn.Sequential(Conv1x1(n_embd, n_hidden), nn.GELU(),
                                 nn.Identity(), Conv1x1(n_hidden, n_embd))
        self.use_drop_path = path_pdrop > 0.0
        if self.use_drop_path:
            self.drop_path_attn = AffineDropPath(n_embd, path_pdrop)
            self.drop_path_mlp = AffineDropPath(n_embd, path_pdrop)

    def packed_weights(self):
        """(lnw3, lnb3 (3, C) [ln11, ln12, ln2], the MHCA's five packed
        weights, w1 (H, C), b1 (H), w2 (C, H), b2 (C)) in the fused kernel's
        layout, H the hidden width."""
        lns = (self.ln11, self.ln12, self.ln2)
        return (torch.stack([n.weight.view(-1) for n in lns]),
                torch.stack([n.bias.view(-1) for n in lns]),
                *self.attn.packed_weights(),
                self.mlp[0].weight[:, :, 0], self.mlp[0].bias,
                self.mlp[3].weight[:, :, 0], self.mlp[3].bias)

    def forward(self, x1, x2, mask, generator: Optional[torch.Generator] = None):
        if (tblock_mode() == "always" and x1 is x2
                and self.n_ds_strides == (1, 1)):
            return self._fused(x1, mask, generator), mask
        out, out_mask = self.attn(self.ln11(x1), self.ln12(x2), mask)
        om = out_mask[..., None].to(out.dtype)
        s = self.n_ds_strides[0]
        if s > 1:
            skip = F.max_pool1d(x1.transpose(1, 2), s + 1, s, (s + 1) // 2).transpose(1, 2)
        else:
            skip = x1
        out = skip * om + (self.drop_path_attn(out, generator) if self.use_drop_path else out)
        fc1, fc2 = self.mlp[0], self.mlp[3]
        h = gelu(dense(self.ln2(out), fc1.weight[:, :, 0], fc1.bias, self.dtype))
        h = dense(h, fc2.weight[:, :, 0], fc2.bias, self.dtype) * om
        out = out + (self.drop_path_mlp(h, generator) if self.use_drop_path else h)
        return out, out_mask

    def _fused(self, x, mask, generator):
        """The whole block as one fused_tblock call, with both droppath draws
        (attn, then mlp) made by the AffineDropPath modules."""
        b, c = x.shape[0], x.shape[-1]
        if self.use_drop_path:
            mult_a = self.drop_path_attn.multiplier(b, generator)
            mult_m = self.drop_path_mlp.multiplier(b, generator)
        else:
            mult_a = mult_m = torch.ones((b, 1, c), device=x.device, dtype=torch.float32)
        return fused_tblock(x.float().contiguous(), mask.contiguous(), mult_a, mult_m,
                            *self.packed_weights(), heads=self.attn.n_head,
                            cdtype=self.dtype or x.dtype)
