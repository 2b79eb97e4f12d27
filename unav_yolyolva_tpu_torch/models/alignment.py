"""Multiway alignment transformer over the raw audio/visual sequences.

Projects raw visual (2048) and audio (128) features to the model width,
prepends per-modality CLS tokens, adds learned position and modality-type
embeddings and runs ONE shared MultiWay block `num_layers` times (the
reference's `ModuleList([module] * n)`; held once here, as
`multiway_list.0`). The attention mask is used in factorized form: each
modality attends its own valid keys plus the other modality's token at the
same index (CLS has no partner), so no (B, N, N) mask is built. The
auxiliary per-frame score/class heads, score losses and contrastive
candidates are computed only when losses are asked for.

Under the bf16 policy (`dtype`) the LayerNorms keep fp32 statistics and
store bf16 (the JAX package's `_ln_dtype` at its default), every dense
layer computes in bf16, the fp32 embeddings are cast to bf16 before the
concat and the adds, the attention accumulates in fp32 and stores bf16,
and the auxiliary outputs (score heads, cls tokens, contrastive
statistics) are fp32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.losses import focal_loss_score
from ..ops.masked import cast, gelu, layer_norm
from .blocks import Conv1x1, dense


def _linear(lin: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    return dense(x, lin.weight, lin.bias, dtype)


class AlignmentMHA(nn.Module):
    def __init__(self, dims: int, heads: int = 8, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dims, self.heads, self.dtype = dims, heads, dtype
        self.q = nn.Linear(dims, dims)
        self.k = nn.Linear(dims, dims)
        self.v = nn.Linear(dims, dims)
        self.m = nn.Linear(dims, dims)

    def forward(self, fused, mask_video, mask_text, n_video: int):
        b, n, _ = fused.shape
        hd = self.dims // self.heads
        scale = 1.0 / math.sqrt(hd)
        qh = _linear(self.q, fused, self.dtype).reshape(b, n, self.heads, hd)
        kh = _linear(self.k, fused, self.dtype).reshape(b, n, self.heads, hd)
        vh = _linear(self.v, fused, self.dtype).reshape(b, n, self.heads, hd)
        neg = torch.finfo(torch.float32).min

        def half(q_s, k_s, v_s, k_o, v_o, key_mask):
            # fp32 sums of the exact products of the compute-dtype values,
            # softmax weights stored in the compute dtype, output likewise
            dt = v_s.dtype
            q_s, k_s, v_s, k_o, v_o = (a.float() for a in (q_s, k_s, v_s, k_o, v_o))
            n_s = q_s.shape[1]
            att = torch.einsum("bqhd,bkhd->bhqk", q_s, k_s) * scale
            att = att.masked_fill(~key_mask[:, None, None, :], neg)
            cross = torch.einsum("bqhd,bqhd->bhq", q_s, k_o) * scale
            is_cls = torch.arange(n_s, device=q_s.device) == 0
            cross = cross.masked_fill(is_cls, neg)     # CLS has no band entry
            w = torch.cat([att, cross[..., None]], dim=-1).softmax(dim=-1).to(dt).float()
            out = torch.einsum("bhqk,bkhd->bqhd", w[..., :n_s], v_s)
            return (out + w[..., n_s].permute(0, 2, 1)[..., None] * v_o).to(dt)

        out_v = half(qh[:, :n_video], kh[:, :n_video], vh[:, :n_video],
                     kh[:, n_video:], vh[:, n_video:], mask_video)
        out_t = half(qh[:, n_video:], kh[:, n_video:], vh[:, n_video:],
                     kh[:, :n_video], vh[:, :n_video], mask_text)
        return _linear(self.m, torch.cat([out_v, out_t], dim=1).reshape(b, n, self.dims),
                       self.dtype)


class AlignmentFFN(nn.Module):
    def __init__(self, num_input: int, ratio: int = 4, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(num_input, num_input * ratio)
        self.fc2 = nn.Linear(num_input * ratio, num_input)

    def forward(self, x):
        return _linear(self.fc2, gelu(_linear(self.fc1, x, self.dtype)), self.dtype)


class MultiWayBlock(nn.Module):
    def __init__(self, num_hidden: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.norm1_fused = nn.LayerNorm(num_hidden, eps=1e-5)
        self.attn_fusion = AlignmentMHA(num_hidden, dtype=dtype)
        self.norm2_video = nn.LayerNorm(num_hidden, eps=1e-5)
        self.norm2_text = nn.LayerNorm(num_hidden, eps=1e-5)
        self.ffn_video = AlignmentFFN(num_hidden, dtype=dtype)
        self.ffn_text = AlignmentFFN(num_hidden, dtype=dtype)

    def forward(self, fused, mask_video, mask_text, n_video: int):
        ln = self.dtype or torch.float32
        residual = fused + self.attn_fusion(layer_norm(fused, self.norm1_fused, ln),
                                            mask_video, mask_text, n_video)
        res_v, res_t = residual[:, :n_video], residual[:, n_video:]
        video = res_v + self.ffn_video(layer_norm(res_v, self.norm2_video, ln))
        text = res_t + self.ffn_text(layer_norm(res_t, self.norm2_text, ln))
        return video, text


def binary_dilate(x: torch.Tensor, iterations: int = 4) -> torch.Tensor:
    """scipy binary_dilation with the 1-connectivity element `iterations`
    times: a max filter of width 2*iterations+1 over (B, T)."""
    w = 2 * iterations + 1
    return F.max_pool1d(x.float()[:, None], w, 1, iterations)[:, 0] > 0.5


def select_contrastive_candidates(score, embedding, mask, key_indicator,
                                  cls_pred, cls_gt, k_max: int) -> Dict:
    """Fixed-size selection of contrastive pairs: masked key-frame means and
    the top-k eligible non-key frames, with the reference's (len-1)/8
    budget (its double CLS strip)."""
    b, t, _ = embedding.shape
    embedding = embedding.float()
    key_mask = key_indicator > 0.5
    key_count = key_mask.sum(dim=1)
    key_mean = (embedding * key_mask[..., None]).sum(dim=1) \
        / key_count.clamp(min=1)[:, None]
    first_key = key_mask.int().argmax(dim=1, keepdim=True)
    key_label = cls_gt.gather(1, first_key)                   # (B, 1)
    length = mask[:, 1:].int().sum(dim=1)
    k_budget = torch.ceil(torch.clamp(length.float() / 8.0, min=1.0)).int()
    pos = torch.arange(t, device=embedding.device)[None, :]
    eligible = (~binary_dilate(key_indicator)) & (cls_pred == key_label) \
        & (pos < length[:, None])
    neg = torch.finfo(torch.float32).min
    ranked = torch.where(eligible, score.float(), torch.full_like(score.float(), neg))
    top_vals, top_idx = ranked.topk(k_max, dim=1)
    rank = torch.arange(k_max, device=embedding.device)[None, :]
    valid = (top_vals > neg) & (rank < k_budget[:, None])
    nonkey = embedding.gather(1, top_idx[..., None].expand(-1, -1, embedding.shape[-1]))
    return {
        "key_mean": key_mean,
        "key_any": key_count > 0,
        "nonkey": nonkey * valid[..., None],
        "nonkey_valid": valid,
    }


class Alignment(nn.Module):
    def __init__(self, video_dim: int = 2048, audio_dim: int = 128,
                 num_hidden: int = 512, num_layers: int = 2,
                 num_classes: int = 100, max_positions: int = 5000,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_layers, self.dtype = num_layers, dtype
        c = num_hidden
        self.proj_fc_video = nn.Sequential(nn.Linear(video_dim, c))
        self.proj_fc_text = nn.Sequential(nn.Linear(audio_dim, c))
        self.cls_token_video = nn.Parameter(torch.empty(1, 1, c))
        self.cls_token_text = nn.Parameter(torch.empty(1, 1, c))
        self.pos_embed_video = nn.Parameter(torch.empty(1, max_positions, c))
        self.pos_embed_text = nn.Parameter(torch.empty(1, max_positions, c))
        self.type_video = nn.Parameter(torch.empty(1, 1, c))
        self.type_text = nn.Parameter(torch.empty(1, 1, c))
        self.multiway_list = nn.ModuleList([MultiWayBlock(c, dtype)])
        self.norm_video = nn.LayerNorm(c, eps=1e-5)
        self.norm_text = nn.LayerNorm(c, eps=1e-5)
        # indices 0 and 3 as in the reference's Sequential(Linear, ReLU, Dropout, LN)
        self.fc_video = nn.Sequential(nn.Linear(c, c), nn.ReLU(), nn.Identity(),
                                      nn.LayerNorm(c, eps=1e-5))
        self.fc_text = nn.Sequential(nn.Linear(c, c), nn.ReLU(), nn.Identity(),
                                     nn.LayerNorm(c, eps=1e-5))
        self.fc_video_score = Conv1x1(c, 1)
        self.fc_text_score = Conv1x1(c, 1)
        self.fc_video_cls = nn.Linear(c, num_classes)
        self.fc_text_cls = nn.Linear(c, num_classes)

    def forward(self, video, text, mask_video, mask_text,
                targets: Optional[Tuple] = None):
        """video (B, T, Dv), text (B, T, Da), masks (B, T). `targets`
        (m_start_end, m_scores, m_labels) turns on the auxiliary outputs."""
        b, t, _ = video.shape
        dt = self.dtype
        ln = dt or torch.float32
        video = _linear(self.proj_fc_video[0], video, dt)
        text = _linear(self.proj_fc_text[0], text, dt)
        residual_video, residual_text = video, text
        n = t + 1
        # the fp32 embeddings cast to the compute dtype before the concat
        # and the adds, which would otherwise promote the sequence
        cdt = video.dtype
        v = torch.cat([cast(self.cls_token_video, cdt).expand(b, -1, -1), video], dim=1)
        x = torch.cat([cast(self.cls_token_text, cdt).expand(b, -1, -1), text], dim=1)
        ones = torch.ones((b, 1), dtype=torch.bool, device=video.device)
        mv = torch.cat([ones, mask_video], dim=1)
        mt = torch.cat([ones, mask_text], dim=1)
        v = v + cast(self.pos_embed_video[:, :n], cdt) + cast(self.type_video, cdt)
        x = x + cast(self.pos_embed_text[:, :n], cdt) + cast(self.type_text, cdt)

        block = self.multiway_list[0]
        fused = torch.cat([v, x], dim=1)
        for _ in range(self.num_layers):
            v, x = block(fused, mv, mt, n)
            fused = torch.cat([v, x], dim=1)

        cls_v, v = v[:, 0], v[:, 1:]
        cls_x, x = x[:, 0], x[:, 1:]
        v = layer_norm(residual_video + v, self.norm_video, ln)
        v = layer_norm(F.relu(_linear(self.fc_video[0], v, dt)), self.fc_video[3], ln)
        x = layer_norm(residual_text + x, self.norm_text, ln)
        x = layer_norm(F.relu(_linear(self.fc_text[0], x, dt)), self.fc_text[3], ln)
        if targets is None:
            return v, x, None

        m_start_end, m_scores, m_labels = targets
        score_v = self.fc_video_score(v)[..., 0]            # fp32 (promoted)
        score_x = self.fc_text_score(x)[..., 0]
        k_max = max(1, -(-(t - 1) // 8))
        cls_gt = m_labels.argmax(dim=2)
        sel_v = select_contrastive_candidates(
            score_v, v, mask_video, m_start_end,
            _linear(self.fc_video_cls, v, dt).argmax(dim=2), cls_gt, k_max)
        sel_x = select_contrastive_candidates(
            score_x, x, mask_text, m_start_end,
            _linear(self.fc_text_cls, x, dt).argmax(dim=2), cls_gt, k_max)
        aux = {
            "cls_video": cls_v.float(),
            "cls_text": cls_x.float(),
            "key_video": sel_v["key_mean"],
            "key_text": sel_x["key_mean"],
            "key_any": sel_v["key_any"],
            "nonkey_video": sel_v["nonkey"],
            "nonkey_video_valid": sel_v["nonkey_valid"],
            "nonkey_text": sel_x["nonkey"],
            "nonkey_text_valid": sel_x["nonkey_valid"],
            "score_loss_video": focal_loss_score(score_v, m_scores, mask_video.float()),
            "score_loss_text": focal_loss_score(score_x, m_scores, mask_text.float()),
        }
        return v, x, aux
