"""Dual-stream conv-transformer backbone with the fusion pyramid.

Per-modality embedding convs + sinusoid PE + stem TransformerBlocks, then a
6-level pyramid (5 depthwise strided downsamples) fused by ONE shared
FusionModule. The reference runs the shared downsample chain and fusion
twice (V guided by A, then A guided by V); every op is batch-parallel with
shared weights, so both passes run as one pass at batch 2B. The
reference's never-called cross-attention blocks are not allocated.

Under the bf16 policy (`dtype`) the embedding convs, LayerNorms, stem
blocks, pyramid and fusion compute in bf16; the fp32 sinusoid PE promotes
the stem's input to fp32, and the stem's residual stream stays fp32.

The PE table is built once per (length, device) and kept on the device
(`pe_table`), so that a forward copies nothing from the host and does not
wait on the device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.masked import gelu, interpolate_pe_linear, sinusoid_encoding
from .blocks import ChannelLayerNorm, MaskedConv1D, TransformerBlock
from .fusion import FusionModule


class DownsamplePyramidLevel(nn.Module):
    """Depthwise strided k=3 conv + channel LayerNorm."""

    def __init__(self, n_embd: int, scale_factor: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.down_conv = MaskedConv1D(n_embd, n_embd, 3, stride=scale_factor,
                                      groups=n_embd, bias=False, dtype=dtype)
        self.down_norm = ChannelLayerNorm(n_embd, dtype=dtype)

    def forward(self, x, mask):
        x, mask = self.down_conv(x, mask)
        return self.down_norm(x), mask


class ConvTransformerBackbone(nn.Module):
    def __init__(self, n_in_V: int = 512, n_in_A: int = 512, n_embd: int = 512,
                 n_head: int = 4, n_embd_ks: int = 3, max_len: int = 224,
                 arch: Tuple[int, int, int] = (2, 3, 5), scale_factor: int = 2,
                 with_ln: bool = True, path_pdrop: float = 0.0,
                 use_abs_pe: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.arch, self.n_embd, self.max_len = tuple(arch), n_embd, max_len
        self.with_ln, self.use_abs_pe = with_ln, use_abs_pe

        def embd(n_in):
            return nn.ModuleList([
                MaskedConv1D(n_in if i == 0 else n_embd, n_embd, n_embd_ks,
                             bias=not with_ln, dtype=dtype) for i in range(arch[0])])

        def norms():
            return nn.ModuleList([ChannelLayerNorm(n_embd, dtype=dtype) if with_ln
                                  else nn.Identity() for _ in range(arch[0])])

        def stem():
            return nn.ModuleList([TransformerBlock(n_embd, n_head, path_pdrop=path_pdrop,
                                                   dtype=dtype)
                                  for _ in range(arch[1] - 1)])

        self.embd_V, self.embd_A = embd(n_in_V), embd(n_in_A)
        self.embd_norm_V, self.embd_norm_A = norms(), norms()
        self.self_att_V, self.self_att_A = stem(), stem()
        self.downsample_list = nn.ModuleList(
            [DownsamplePyramidLevel(n_embd, scale_factor, dtype) for _ in range(arch[2])])
        self.fusion_module = FusionModule(n_embd, seq_len=max_len, num_levels=arch[2] + 1,
                                          dtype=dtype)
        # {(length, device): the scaled fp32 PE table}; not module state
        self._pe: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def pe_table(self, t: int, device: torch.device) -> torch.Tensor:
        """The (t, C) fp32 sinusoid table over sqrt(C), interpolated for t
        >= max_len, built on `device` at its first use for (t, device) and
        kept there. The same ops on the same device as at every forward
        before, so the same bits; built outside inference mode, so that a
        training forward may use a table an eval forward built."""
        key = (t, torch.device(device))
        pe = self._pe.get(key)
        if pe is None:
            with torch.inference_mode(False), torch.no_grad():
                pe = torch.from_numpy(sinusoid_encoding(self.max_len, self.n_embd)).to(
                    device) / (self.n_embd ** 0.5)
                pe = interpolate_pe_linear(pe, t) if t >= self.max_len else pe[:t]
            self._pe[key] = pe
        return pe

    def forward(self, x_v, x_a, mask, generator: Optional[torch.Generator] = None):
        """`generator` draws the stem's stochastic depth in training."""
        mask_v = mask_a = mask
        t = x_v.shape[1]
        for conv_v, norm_v, conv_a, norm_a in zip(self.embd_V, self.embd_norm_V,
                                                  self.embd_A, self.embd_norm_A):
            x_v, mask_v = conv_v(x_v, mask_v)
            x_v = gelu(norm_v(x_v))
            x_a, mask_a = conv_a(x_a, mask_a)
            x_a = gelu(norm_a(x_a))

        if self.use_abs_pe:
            pe = self.pe_table(t, x_v.device)
            x_v = x_v + pe[None] * mask_v[..., None].to(x_v.dtype)
            x_a = x_a + pe[None] * mask_a[..., None].to(x_a.dtype)

        for blk_v, blk_a in zip(self.self_att_V, self.self_att_A):
            x_v, mask_v = blk_v(x_v, x_v, mask_v, generator)
            x_a, mask_a = blk_a(x_a, x_a, mask_a, generator)

        b = x_v.shape[0]
        both = [torch.cat([x_v, x_a], dim=0)]
        masks = [torch.cat([mask_v, mask_a], dim=0)]
        for ds in self.downsample_list:
            nxt, mnxt = ds(both[-1], masks[-1])
            both.append(nxt)
            masks.append(mnxt)
        # the V half is guided by the A stem, the A half by the V stem
        guide = torch.cat([x_a, x_v], dim=0)
        guide_mask = torch.cat([mask_a, mask_v], dim=0)
        feats, _, masks, _ = self.fusion_module(both, guide, masks, guide_mask)
        return [f[:b] for f in feats], [f[b:] for f in feats], [m[:b] for m in masks]
