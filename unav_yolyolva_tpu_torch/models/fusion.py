"""YOLO-World-style PAFPN fusion over the 6-level temporal pyramid.

Reference quirks kept because they shape the parameters or the numbers:
top-down CSP layers use attention heads [8, 4, 4, 4, 4], bottom-up 8; every
MHCA inside a CSP layer has 4 heads; the five bottom-up downsamples share
one module; the guide is the other modality's (B, T, C) map read as C
tokens of width T (so guide_fc's input width is the train sequence length);
the text enhancer pools with adaptive AVERAGE pooling and ignores the mask;
the top-down path upsamples the coarse level's mask.

Under the bf16 policy (`dtype`) each CSP layer casts its input and guide
to bf16 before the fused layer, as the JAX package's does; the shared
downsample and the text enhancer compute in bf16.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..ops.fused_csp import fused_csp
from ..ops.masked import (adaptive_avg_pool1d, resample_mask_nearest,
                          resample_time_linear, silu)
from .blocks import ChannelLayerNorm, Conv1x1, MaskedConv1D, MaskedMHCA


class MaxSigmoidAttnBlock(nn.Module):
    """Parameters of the cross-modal max-sigmoid gate: guide_fc, the per-head
    bias and the k=3 project_conv. Its computation is part of the fused CSP
    layer (ops/fused_csp.py). Only the embed == in_channels form exists in
    the model, so there is no embed_conv."""

    def __init__(self, in_channels: int, out_channels: int,
                 guide_in_features: int, embed_channels: int, num_heads: int):
        super().__init__()
        assert embed_channels == in_channels and out_channels % num_heads == 0
        self.num_heads = num_heads
        self.guide_fc = nn.Linear(guide_in_features, embed_channels)
        self.bias = nn.Parameter(torch.empty(num_heads))
        self.project_conv = MaskedConv1D(in_channels, out_channels, 3)


class MaxSigmoidCSPLayer(nn.Module):
    """CSP layer: main conv split, 3 chained MHCA blocks, max-sigmoid guide
    attention, final conv over the 6-part concat; runs as ops/fused_csp."""

    def __init__(self, in_channels: int, out_channels: int,
                 guide_in_features: int, embed_channels: int, num_heads: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        mid = out_channels // 2
        self.main_conv = MaskedConv1D(in_channels, 2 * mid, 1)
        self.blocks = nn.ModuleList([MaskedMHCA(mid, 4) for _ in range(3)])
        self.attn_block = MaxSigmoidAttnBlock(mid, mid, guide_in_features,
                                              embed_channels, num_heads)
        self.final_conv = MaskedConv1D(6 * mid, out_channels, 1)

    def forward(self, x: torch.Tensor, guide: torch.Tensor, mask: torch.Tensor):
        packs = [blk.packed_weights() for blk in self.blocks]
        ab = self.attn_block
        dt = self.dtype or x.dtype
        out = fused_csp(
            x.to(dt).contiguous(), guide.to(dt).contiguous(), mask.contiguous(),
            self.main_conv.conv.weight[:, :, 0], self.main_conv.conv.bias,
            *[torch.stack([p[i] for p in packs]) for i in range(5)],
            ab.guide_fc.weight, ab.guide_fc.bias, ab.bias,
            ab.project_conv.conv.weight, ab.project_conv.conv.bias,
            self.final_conv.conv.weight[:, :, 0], self.final_conv.conv.bias,
            attn_heads=ab.num_heads, mhca_heads=4,
        )
        return out, mask


class DownsampleSiLU(nn.Module):
    """Strided conv + channel LayerNorm + SiLU."""

    def __init__(self, n_embd: int, scale_factor: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        k = scale_factor + 1 if scale_factor > 1 else 3
        self.down_conv = MaskedConv1D(n_embd, n_embd, k, stride=scale_factor, dtype=dtype)
        self.down_norm = ChannelLayerNorm(n_embd, dtype=dtype)

    def forward(self, x, mask):
        x, mask = self.down_conv(x, mask)
        return silu(self.down_norm(x)), mask


class FusionModule(nn.Module):
    """Audio/visual-guided PAFPN; one instance serves both modality passes
    (run together at batch 2B by the backbone)."""

    def __init__(self, n_embd: int = 512, seq_len: int = 224, num_levels: int = 6,
                 pool_size: int = 4, pool_levels: int = 3,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.seq_len, self.num_levels = seq_len, num_levels
        self.pool_size, self.pool_levels = pool_size, pool_levels
        embed_ch = n_embd // 2

        def csp(heads):
            return MaxSigmoidCSPLayer(2 * n_embd, n_embd, seq_len, embed_ch, heads, dtype)

        self.top_down_layers = nn.ModuleList(
            [csp(h) for h in [8, 4, 4, 4, 4][: num_levels - 1]])
        self.bottom_up_layers = nn.ModuleList(
            [csp(8) for _ in range(num_levels - 1)])
        # one shared instance; the reference lists it five times
        self.downsample_layers = nn.ModuleList([DownsampleSiLU(n_embd, dtype=dtype)])
        self.text_enhancer = MaskedMHCA(n_embd, 4, dtype=dtype)
        self.match_projection = Conv1x1(pool_levels * pool_size, seq_len)

    def forward(self, img_feats: List[torch.Tensor], txt_feats: torch.Tensor,
                mask_img: List[torch.Tensor], mask_txt: torch.Tensor):
        nl = self.num_levels
        # inputs longer than seq_len: the guide subgraph runs on a linearly
        # resampled width-seq_len view (no-op at T == seq_len)
        if txt_feats.shape[1] != self.seq_len:
            txt_feats = resample_time_linear(txt_feats, self.seq_len)
            mask_txt = resample_mask_nearest(mask_txt, self.seq_len)
        guide = txt_feats.transpose(1, 2).contiguous()            # (B, C, T)

        inner_outs = [img_feats[-1]]
        for idx in range(nl - 1, 0, -1):
            upsample = inner_outs[0].repeat_interleave(2, dim=1)
            mask_up = mask_img[idx].repeat_interleave(2, dim=1)   # coarse mask
            td_in = torch.cat([upsample, img_feats[idx - 1]], dim=-1)
            inner, _ = self.top_down_layers[nl - 1 - idx](td_in, guide, mask_up)
            inner_outs.insert(0, inner)

        pooled = torch.cat([adaptive_avg_pool1d(inner_outs[i], self.pool_size)
                            for i in range(self.pool_levels)], dim=1)   # (B, 12, C)
        mp = self.match_projection
        mlvl = torch.einsum("bkc,ok->boc", pooled.float(), mp.weight[:, :, 0]) \
            + mp.bias[None, :, None]                                # (B, T, C) fp32
        txt_enh, mask_txt = self.text_enhancer(txt_feats, mlvl, mask_txt)
        guide_enh = txt_enh.transpose(1, 2).contiguous()

        outs = [inner_outs[0]]
        down_layer = self.downsample_layers[0]
        for idx in range(nl - 1):
            down, mask_down = down_layer(outs[-1], mask_img[idx])
            bu_in = torch.cat([down, inner_outs[idx + 1]], dim=-1)
            out, _ = self.bottom_up_layers[idx](bu_in, guide_enh, mask_down)
            outs.append(out)
        # the reference returns the input pyramid masks
        return outs, txt_enh, mask_img, mask_txt
