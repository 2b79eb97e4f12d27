"""Functions on masked (B, T, C) sequences.

Activations are (B, T, C) with a (B, T) bool validity mask, as in the JAX
package, so every function here has a same-named counterpart there.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def masked_conv1d_out_mask(mask: torch.Tensor, stride: int) -> torch.Tensor:
    """Mask after a strided conv: every stride-th frame from index 0 (equal
    to the reference's nearest interpolation for integer factors)."""
    if stride == 1:
        return mask
    return mask[:, ::stride]


def cast(w: Optional[torch.Tensor], dtype: Optional[torch.dtype]) -> Optional[torch.Tensor]:
    """An fp32 parameter cast to the compute dtype at the call, as flax's
    `dtype=` casts a module's kernel and bias (the parameters themselves
    stay fp32); None and dtype None pass through."""
    return w if w is None or dtype is None else w.to(dtype)


def channel_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, eps: float = 1e-5,
                       out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """LayerNorm over the last axis with biased variance, fp32 statistics
    and fp32 affine; stored in `out_dtype` (default: x's), as the JAX
    package's ChannelLayerNorm(dtype=) stores it."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    res = xf - mu
    sigma = (res * res).mean(dim=-1, keepdim=True)
    out = res * torch.rsqrt(sigma + eps)
    return (out * weight + bias).to(out_dtype or x.dtype)


def layer_norm(x: torch.Tensor, ln: torch.nn.LayerNorm,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """An nn.LayerNorm with fp32 statistics and affine, stored in
    `out_dtype` (default: x's): flax's LayerNorm(dtype=)."""
    if x.dtype == torch.float32 and out_dtype in (None, torch.float32):
        return ln(x)
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)
    return y.to(out_dtype or x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU. In bf16 each step rounds to bf16 as jax.nn.gelu's
    ops do: 0.5 x * erfc(-x * bf16(sqrt(1/2)))."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x)
    s = torch.tensor(math.sqrt(0.5), dtype=x.dtype)
    return (0.5 * x) * torch.special.erfc(-x * s)


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x). In bf16 each step rounds to bf16 as jax.nn.silu's
    ops do (sigmoid as 1 / (1 + exp(-x)))."""
    if x.dtype != torch.bfloat16:
        return F.silu(x)
    return x * (1 / (1 + torch.exp(-x)))


def sinusoid_encoding(n_position: int, d_hid: int) -> np.ndarray:
    """Sin/cos positional table (T, C) float32, built in float64."""
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    dim = np.arange(d_hid, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2.0 * (dim // 2) / d_hid)
    table = np.empty((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)


def _linear_coords(t_in: int, new_len: int, device):
    """Half-pixel source coordinates of F.interpolate(mode='linear',
    align_corners=False), computed in float32 like the JAX package."""
    src = (torch.arange(new_len, dtype=torch.float32, device=device) + 0.5) \
        * (t_in / new_len) - 0.5
    src = src.clamp(0.0, t_in - 1)
    lo = src.floor().long()
    hi = (lo + 1).clamp(max=t_in - 1)
    return lo, hi, src - lo.float()


def interpolate_pe_linear(pe: torch.Tensor, new_len: int) -> torch.Tensor:
    """Linear interpolation of a positional table (T, C) -> (new_len, C)."""
    if pe.shape[0] == new_len:
        return pe
    lo, hi, w = _linear_coords(pe.shape[0], new_len, pe.device)
    w = w[:, None]
    return pe[lo] * (1.0 - w) + pe[hi] * w


def resample_time_linear(x: torch.Tensor, new_len: int) -> torch.Tensor:
    """Linear resampling of the T axis of (B, T, C) -> (B, new_len, C)."""
    if x.shape[1] == new_len:
        return x
    lo, hi, w = _linear_coords(x.shape[1], new_len, x.device)
    w = w[None, :, None]
    return (x[:, lo] * (1.0 - w) + x[:, hi] * w).to(x.dtype)


def resample_mask_nearest(mask: torch.Tensor, new_len: int) -> torch.Tensor:
    """Nearest resampling of a (B, T) mask to (B, new_len)."""
    t_in = mask.shape[1]
    if t_in == new_len:
        return mask
    src = ((torch.arange(new_len, dtype=torch.float32, device=mask.device) + 0.5)
           * (t_in / new_len)).long().clamp(0, t_in - 1)
    return mask[:, src]


def adaptive_avg_pool1d(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """nn.AdaptiveAvgPool1d over the T axis of (..., T, C): bin i covers
    [floor(i*T/out), ceil((i+1)*T/out)); the mask is ignored, as in the
    reference."""
    t_in = x.shape[-2]
    if t_in % out_size == 0:
        k = t_in // out_size
        return x.reshape(x.shape[:-2] + (out_size, k, x.shape[-1])).mean(dim=-2)
    outs = []
    for i in range(out_size):
        lo = (i * t_in) // out_size
        hi = -(-((i + 1) * t_in) // out_size)
        outs.append(x[..., lo:hi, :].mean(dim=-2))
    return torch.stack(outs, dim=-2)
