"""The plain float32 reference of the UnAV-100 detector (LocPointTransformer):
Alignment -> dual-stream conv-transformer stem -> 6-level pyramid fused by
the audio/visual-guided PAFPN -> cls/reg heads, with the contrastive and
score losses of the training forward.

A frozen, stand-alone copy of the port's plain path at float32: the same
module tree and parameter names (the reference key space), so one state
dict loads with strict=True into both. It imports nothing of the port; the
fused MHCA and CSP layers are written out as plain products. Every product
goes through `prec` (`prec.precision` lowers them all for the control).

Layout: activations (B, T, C) with a (B, T) bool mask. Stochastic depth
takes its multipliers from `drops`, a list in the order the port draws them
(`stem_drops`), so that a forward recomputed under checkpointing, or run in
row blocks, uses the same draws.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import prec

NEG = torch.finfo(torch.float32).min


# ---------------------------------------------------------------- functions
def channel_ln(x, weight, bias, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    res = x - mu
    return res * torch.rsqrt((res * res).mean(dim=-1, keepdim=True) + eps) * weight.view(-1) \
        + bias.view(-1)


def masked_conv(conv: nn.Conv1d, x, mask, stride=1):
    y = prec.conv1d(x.transpose(1, 2), conv.weight, conv.bias, stride,
                    conv.kernel_size[0] // 2, conv.groups).transpose(1, 2)
    out_mask = mask if stride == 1 else mask[:, ::stride]
    return y * out_mask[..., None].float(), out_mask


def pointwise(mod, x):
    """A Conv1x1 (weight (out, in, 1)) over the last axis."""
    return prec.linear(x, mod.weight[:, :, 0], mod.bias)


def attend(q, k, v, kv_mask, heads):
    b, tq, c = q.shape
    tk, d = k.shape[1], c // heads
    att = prec.matmul(q.reshape(b, tq, heads, d).transpose(1, 2),
                      k.reshape(b, tk, heads, d).permute(0, 2, 3, 1))
    any_kv = kv_mask.any(dim=-1)[:, None, None, None]
    att = att.masked_fill(~kv_mask[:, None, None, :], NEG)
    att = torch.where(any_kv, att, torch.zeros((), device=att.device))
    att = att.softmax(dim=-1) * any_kv.float()
    out = prec.matmul(att, v.reshape(b, tk, heads, d).transpose(1, 2))
    return out.transpose(1, 2).reshape(b, tq, c)


def sinusoid_encoding(n_position: int, d_hid: int) -> np.ndarray:
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    dim = np.arange(d_hid, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2.0 * (dim // 2) / d_hid)
    table = np.empty((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)


def adaptive_avg_pool(x, out_size):
    t_in = x.shape[-2]
    if t_in % out_size == 0:
        return x.reshape(x.shape[:-2] + (out_size, t_in // out_size, x.shape[-1])).mean(-2)
    outs = [x[..., (i * t_in) // out_size:-(-((i + 1) * t_in) // out_size), :].mean(-2)
            for i in range(out_size)]
    return torch.stack(outs, dim=-2)


def _call(fn, *args, ckpt=False):
    if ckpt and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ------------------------------------------------------------------ modules
class Conv1x1(nn.Module):
    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, 1))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None


class ConvBox(nn.Module):
    """Holds `conv`, as the port's MaskedConv1D does (key `...conv.weight`)."""

    def __init__(self, cin, cout, k, stride=1, groups=1, bias=True):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv1d(cin, cout, k, stride, k // 2, groups=groups, bias=bias)

    def forward(self, x, mask):
        return masked_conv(self.conv, x, mask, self.stride)


class ChannelLN(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(1, c, 1))
        self.bias = nn.Parameter(torch.empty(1, c, 1))

    def forward(self, x):
        return channel_ln(x, self.weight, self.bias)


class Scale(nn.Module):
    def __init__(self, shape):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(shape))


class MHCA(nn.Module):
    """Masked multi-head conv attention at stride 1: x1 gives keys and
    values, x2 the queries."""

    def __init__(self, c, heads):
        super().__init__()
        self.heads = heads
        for n in ("query", "key", "value"):
            setattr(self, f"{n}_conv", ConvBox(c, c, 3, groups=c, bias=False))
            setattr(self, f"{n}_norm", ChannelLN(c))
            setattr(self, n, Conv1x1(c, c))
        self.proj = Conv1x1(c, c)

    def forward(self, x1, x2, mask):
        c = x1.shape[-1]
        mm = mask[..., None].float()

        def dw_ln(x, conv, norm):
            y = prec.conv1d(x.transpose(1, 2), conv.conv.weight, None, 1, 1, c).transpose(1, 2)
            return norm(y * mm)

        q = pointwise(self.query, dw_ln(x2, self.query_conv, self.query_norm)) \
            * (1.0 / math.sqrt(c // self.heads))
        k = pointwise(self.key, dw_ln(x1, self.key_conv, self.key_norm))
        v = pointwise(self.value, dw_ln(x1, self.value_conv, self.value_norm)) * mm
        return pointwise(self.proj, attend(q, k, v, mask, self.heads)) * mm


class TransformerBlock(nn.Module):
    def __init__(self, c, heads, droppath):
        super().__init__()
        self.ln11, self.ln12, self.ln2 = ChannelLN(c), ChannelLN(c), ChannelLN(c)
        self.attn = MHCA(c, heads)
        self.mlp = nn.ModuleList([Conv1x1(c, 4 * c), nn.Identity(), nn.Identity(),
                                  Conv1x1(4 * c, c)])
        self.use_drop_path = droppath > 0
        if self.use_drop_path:
            self.drop_path_attn = Scale((1, c, 1))
            self.drop_path_mlp = Scale((1, c, 1))

    def forward(self, x, mask, drop_a=None, drop_m=None):
        om = mask[..., None].float()
        out = self.attn(self.ln11(x), self.ln12(x), mask)
        if self.use_drop_path:
            out = out * self.drop_path_attn.scale.view(1, 1, -1)
            if drop_a is not None:
                out = out * drop_a
        out = x * om + out
        h = F.gelu(pointwise(self.mlp[0], self.ln2(out)))
        h = pointwise(self.mlp[3], h) * om
        if self.use_drop_path:
            h = h * self.drop_path_mlp.scale.view(1, 1, -1)
            if drop_m is not None:
                h = h * drop_m
        return out + h


class AttnBlock(nn.Module):
    def __init__(self, mid, guide_in, heads):
        super().__init__()
        self.heads = heads
        self.guide_fc = nn.Linear(guide_in, mid)
        self.bias = nn.Parameter(torch.empty(heads))
        self.project_conv = ConvBox(mid, mid, 3)


class CSPLayer(nn.Module):
    """Main conv split in two, three chained MHCAs, the max-sigmoid guide
    gate on a k=3 projection, the final conv over the six parts."""

    def __init__(self, cin, cout, guide_in, heads):
        super().__init__()
        mid = cout // 2
        self.main_conv = ConvBox(cin, 2 * mid, 1)
        self.blocks = nn.ModuleList([MHCA(mid, 4) for _ in range(3)])
        self.attn_block = AttnBlock(mid, guide_in, heads)
        self.final_conv = ConvBox(6 * mid, cout, 1)

    def forward(self, x, guide, mask):
        r, t, _ = x.shape
        mid = self.blocks[0].proj.weight.shape[0]
        mm = mask[..., None].float()
        y = prec.linear(x, self.main_conv.conv.weight[:, :, 0], self.main_conv.conv.bias) * mm
        parts = [y[..., :mid], y[..., mid:]]
        for blk in self.blocks:
            parts.append(blk(parts[-1], parts[-1], mask))
        p = parts[-1]
        ab = self.attn_block
        gp = prec.linear(guide, ab.guide_fc.weight, ab.guide_fc.bias)      # (R, Ng, mid)
        pc, _ = ab.project_conv(p, mask)
        h = ab.heads
        hc = mid // h
        sc = prec.einsum("rthc,rnhc->rhtn", p.reshape(r, t, h, hc), gp.reshape(r, -1, h, hc))
        gate = torch.sigmoid(sc.amax(dim=-1) / math.sqrt(hc) + ab.bias[None, :, None])
        parts.append((pc.reshape(r, t, h, hc) * gate.transpose(1, 2)[..., None])
                     .reshape(r, t, mid))
        return prec.linear(torch.cat(parts, -1), self.final_conv.conv.weight[:, :, 0],
                           self.final_conv.conv.bias) * mm


class DownLN(nn.Module):
    def __init__(self, c, depthwise):
        super().__init__()
        self.depthwise = depthwise
        self.down_conv = ConvBox(c, c, 3, 2, groups=c if depthwise else 1, bias=not depthwise)
        self.down_norm = ChannelLN(c)

    def forward(self, x, mask):
        x, mask = self.down_conv(x, mask)
        x = self.down_norm(x)
        return (x if self.depthwise else F.silu(x)), mask


class Fusion(nn.Module):
    def __init__(self, c, seq_len, levels):
        super().__init__()
        self.seq_len, self.levels = seq_len, levels
        self.top_down_layers = nn.ModuleList(
            [CSPLayer(2 * c, c, seq_len, h) for h in [8, 4, 4, 4, 4][:levels - 1]])
        self.bottom_up_layers = nn.ModuleList(
            [CSPLayer(2 * c, c, seq_len, 8) for _ in range(levels - 1)])
        self.downsample_layers = nn.ModuleList([DownLN(c, depthwise=False)])
        self.text_enhancer = MHCA(c, 4)
        self.match_projection = Conv1x1(12, seq_len)

    def forward(self, feats, txt, masks, mask_txt, ckpt=False):
        nl = self.levels
        assert txt.shape[1] == self.seq_len, "the reference serves T == max_seq_len only"
        guide = txt.transpose(1, 2)
        inner = [feats[-1]]
        for idx in range(nl - 1, 0, -1):
            up = inner[0].repeat_interleave(2, dim=1)
            mask_up = masks[idx].repeat_interleave(2, dim=1)
            inner.insert(0, _call(self.top_down_layers[nl - 1 - idx],
                                  torch.cat([up, feats[idx - 1]], -1), guide, mask_up,
                                  ckpt=ckpt))
        pooled = torch.cat([adaptive_avg_pool(inner[i], 4) for i in range(3)], dim=1)
        mp = self.match_projection
        mlvl = prec.einsum("bkc,ok->boc", pooled, mp.weight[:, :, 0]) + mp.bias[None, :, None]
        txt_enh = self.text_enhancer(txt, mlvl, mask_txt)
        guide_enh = txt_enh.transpose(1, 2)
        outs = [inner[0]]
        for idx in range(nl - 1):
            down, mask_down = self.downsample_layers[0](outs[-1], masks[idx])
            outs.append(_call(self.bottom_up_layers[idx], torch.cat([down, inner[idx + 1]], -1),
                              guide_enh, mask_down, ckpt=ckpt))
        return outs


class Backbone(nn.Module):
    def __init__(self, dv, da, c, heads, max_len, arch, droppath):
        super().__init__()
        self.c, self.max_len = c, max_len
        self.embd_V = nn.ModuleList([ConvBox(dv if i == 0 else c, c, 3, bias=False)
                                     for i in range(arch[0])])
        self.embd_A = nn.ModuleList([ConvBox(da if i == 0 else c, c, 3, bias=False)
                                     for i in range(arch[0])])
        self.embd_norm_V = nn.ModuleList([ChannelLN(c) for _ in range(arch[0])])
        self.embd_norm_A = nn.ModuleList([ChannelLN(c) for _ in range(arch[0])])
        self.self_att_V = nn.ModuleList([TransformerBlock(c, heads, droppath)
                                         for _ in range(arch[1] - 1)])
        self.self_att_A = nn.ModuleList([TransformerBlock(c, heads, droppath)
                                         for _ in range(arch[1] - 1)])
        self.downsample_list = nn.ModuleList([DownLN(c, depthwise=True)
                                              for _ in range(arch[2])])
        self.fusion_module = Fusion(c, max_len, arch[2] + 1)

    def forward(self, xv, xa, mask, drops=None, ckpt=False):
        t = xv.shape[1]
        for conv_v, norm_v, conv_a, norm_a in zip(self.embd_V, self.embd_norm_V,
                                                  self.embd_A, self.embd_norm_A):
            xv = F.gelu(norm_v(conv_v(xv, mask)[0]))
            xa = F.gelu(norm_a(conv_a(xa, mask)[0]))
        pe = torch.from_numpy(sinusoid_encoding(self.max_len, self.c)).to(xv.device) \
            / (self.c ** 0.5)
        assert t == self.max_len, "the reference serves T == max_seq_len only"
        mf = mask[..., None].float()
        xv, xa = xv + pe[None] * mf, xa + pe[None] * mf
        d = iter(drops) if drops is not None else None
        for blk_v, blk_a in zip(self.self_att_V, self.self_att_A):
            dv = (next(d), next(d)) if d else (None, None)
            da = (next(d), next(d)) if d else (None, None)
            xv = _call(blk_v, xv, mask, *dv, ckpt=ckpt)
            xa = _call(blk_a, xa, mask, *da, ckpt=ckpt)
        b = xv.shape[0]
        both, masks = [torch.cat([xv, xa], 0)], [torch.cat([mask, mask], 0)]
        for ds in self.downsample_list:
            nxt, mnxt = ds(both[-1], masks[-1])
            both.append(nxt)
            masks.append(mnxt)
        feats = self.fusion_module(both, torch.cat([xa, xv], 0), masks,
                                   torch.cat([mask, mask], 0), ckpt=ckpt)
        return [f[:b] for f in feats], [f[b:] for f in feats], [m[:b] for m in masks]


class Tower(nn.Module):
    def __init__(self, cin, c, layers):
        super().__init__()
        dims = [cin] + [c] * (layers - 1)
        self.head = nn.ModuleList([ConvBox(dims[i], c, 3, bias=False)
                                   for i in range(layers - 1)])
        self.norm = nn.ModuleList([ChannelLN(c) for _ in range(layers - 1)])

    def tower(self, x, mask):
        for conv, norm in zip(self.head, self.norm):
            x = F.relu(norm(conv(x, mask)[0]))
        return x


class ClsHead(Tower):
    def __init__(self, cin, c, classes, layers):
        super().__init__(cin, c, layers)
        self.cls_head = ConvBox(c, classes, 3)

    def forward(self, feats, masks):
        return [self.cls_head(self.tower(f, m), m)[0] for f, m in zip(feats, masks)]


class RegHead(Tower):
    def __init__(self, cin, c, classes, levels, layers):
        super().__init__(cin, c, layers)
        self.offset_head = ConvBox(c, 2 * classes, 3)
        self.scale = nn.ModuleList([Scale(()) for _ in range(levels)])

    def forward(self, feats, masks):
        return [F.relu(self.offset_head(self.tower(f, m), m)[0] * s.scale)
                for s, f, m in zip(self.scale, feats, masks)]


class AlignmentMHA(nn.Module):
    def __init__(self, c, heads=8):
        super().__init__()
        self.c, self.heads = c, heads
        self.q, self.k, self.v, self.m = (nn.Linear(c, c) for _ in range(4))

    def forward(self, fused, mask_v, mask_t, n_v):
        b, n, _ = fused.shape
        hd = self.c // self.heads
        scale = 1.0 / math.sqrt(hd)
        qh, kh, vh = (prec.linear(fused, lin.weight, lin.bias).reshape(b, n, self.heads, hd)
                      for lin in (self.q, self.k, self.v))

        def half(q_s, k_s, v_s, k_o, v_o, key_mask):
            n_s = q_s.shape[1]
            att = prec.einsum("bqhd,bkhd->bhqk", q_s, k_s) * scale
            att = att.masked_fill(~key_mask[:, None, None, :], NEG)
            cross = (q_s * k_o).sum(-1).permute(0, 2, 1) * scale       # (B, H, Tq)
            cross = cross.masked_fill(torch.arange(n_s, device=q_s.device) == 0, NEG)
            w = torch.cat([att, cross[..., None]], dim=-1).softmax(dim=-1)
            out = prec.einsum("bhqk,bkhd->bqhd", w[..., :n_s], v_s)
            return out + w[..., n_s].permute(0, 2, 1)[..., None] * v_o

        out_v = half(qh[:, :n_v], kh[:, :n_v], vh[:, :n_v], kh[:, n_v:], vh[:, n_v:], mask_v)
        out_t = half(qh[:, n_v:], kh[:, n_v:], vh[:, n_v:], kh[:, :n_v], vh[:, :n_v], mask_t)
        return prec.linear(torch.cat([out_v, out_t], 1).reshape(b, n, self.c),
                           self.m.weight, self.m.bias)


class FFN(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(c, 4 * c), nn.Linear(4 * c, c)

    def forward(self, x):
        return prec.linear(F.gelu(prec.linear(x, self.fc1.weight, self.fc1.bias)),
                           self.fc2.weight, self.fc2.bias)


class MultiWay(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.norm1_fused = nn.LayerNorm(c, eps=1e-5)
        self.attn_fusion = AlignmentMHA(c)
        self.norm2_video = nn.LayerNorm(c, eps=1e-5)
        self.norm2_text = nn.LayerNorm(c, eps=1e-5)
        self.ffn_video, self.ffn_text = FFN(c), FFN(c)

    def forward(self, fused, mask_v, mask_t, n_v):
        res = fused + self.attn_fusion(self.norm1_fused(fused), mask_v, mask_t, n_v)
        rv, rt = res[:, :n_v], res[:, n_v:]
        return torch.cat([rv + self.ffn_video(self.norm2_video(rv)),
                          rt + self.ffn_text(self.norm2_text(rt))], 1)


def binary_dilate(x, iterations=4):
    w = 2 * iterations + 1
    return F.max_pool1d(x.float()[:, None], w, 1, iterations)[:, 0] > 0.5


def contrastive_candidates(score, emb, mask, key_ind, cls_pred, cls_gt, k_max):
    b, t, _ = emb.shape
    key_mask = key_ind > 0.5
    key_count = key_mask.sum(dim=1)
    key_mean = (emb * key_mask[..., None]).sum(1) / key_count.clamp(min=1)[:, None]
    key_label = cls_gt.gather(1, key_mask.int().argmax(dim=1, keepdim=True))
    length = mask[:, 1:].int().sum(dim=1)
    k_budget = torch.ceil(torch.clamp(length.float() / 8.0, min=1.0)).int()
    pos = torch.arange(t, device=emb.device)[None, :]
    eligible = (~binary_dilate(key_ind)) & (cls_pred == key_label) & (pos < length[:, None])
    ranked = torch.where(eligible, score, torch.full_like(score, NEG))
    top_vals, top_idx = ranked.topk(k_max, dim=1)
    valid = (top_vals > NEG) & (torch.arange(k_max, device=emb.device)[None, :]
                                < k_budget[:, None])
    nonkey = emb.gather(1, top_idx[..., None].expand(-1, -1, emb.shape[-1]))
    return key_mean, key_count > 0, nonkey * valid[..., None], valid


def focal_score_loss(pred, target, weights, alpha=0.25, gamma=2.0):
    p = torch.sigmoid(pred)
    p_t = p * target + (1.0 - p) * (1.0 - target)
    alpha_t = alpha * target + (1.0 - alpha) * (1.0 - target)
    return (-alpha_t * (1.0 - p_t) ** gamma * torch.log(p_t.clamp(min=1e-7)) * weights).sum()


class Alignment(nn.Module):
    def __init__(self, dv, da, c, classes, layers=2, max_pos=5000):
        super().__init__()
        self.layers = layers
        self.proj_fc_video = nn.ModuleList([nn.Linear(dv, c)])
        self.proj_fc_text = nn.ModuleList([nn.Linear(da, c)])
        for n in ("cls_token_video", "cls_token_text", "type_video", "type_text"):
            setattr(self, n, nn.Parameter(torch.empty(1, 1, c)))
        self.pos_embed_video = nn.Parameter(torch.empty(1, max_pos, c))
        self.pos_embed_text = nn.Parameter(torch.empty(1, max_pos, c))
        self.multiway_list = nn.ModuleList([MultiWay(c)])
        self.norm_video = nn.LayerNorm(c, eps=1e-5)
        self.norm_text = nn.LayerNorm(c, eps=1e-5)
        self.fc_video = nn.ModuleList([nn.Linear(c, c), nn.Identity(), nn.Identity(),
                                       nn.LayerNorm(c, eps=1e-5)])
        self.fc_text = nn.ModuleList([nn.Linear(c, c), nn.Identity(), nn.Identity(),
                                      nn.LayerNorm(c, eps=1e-5)])
        self.fc_video_score, self.fc_text_score = Conv1x1(c, 1), Conv1x1(c, 1)
        self.fc_video_cls, self.fc_text_cls = nn.Linear(c, classes), nn.Linear(c, classes)

    def forward(self, video, text, mask, targets=None, ckpt=False):
        b, t, _ = video.shape
        lin = self.proj_fc_video[0]
        video = prec.linear(video, lin.weight, lin.bias)
        text = prec.linear(text, self.proj_fc_text[0].weight, self.proj_fc_text[0].bias)
        n = t + 1
        v = torch.cat([self.cls_token_video.expand(b, -1, -1), video], 1) \
            + self.pos_embed_video[:, :n] + self.type_video
        x = torch.cat([self.cls_token_text.expand(b, -1, -1), text], 1) \
            + self.pos_embed_text[:, :n] + self.type_text
        m1 = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=mask.device), mask], 1)
        fused = torch.cat([v, x], 1)
        for _ in range(self.layers):
            fused = _call(self.multiway_list[0], fused, m1, m1, n, ckpt=ckpt)
        cls_v, v = fused[:, 0], fused[:, 1:n]
        cls_x, x = fused[:, n], fused[:, n + 1:]

        def out(res, y, norm, fc):
            y = norm(res + y)
            return fc[3](F.relu(prec.linear(y, fc[0].weight, fc[0].bias)))

        v = out(video, v, self.norm_video, self.fc_video)
        x = out(text, x, self.norm_text, self.fc_text)
        if targets is None:
            return v, x, None
        m_start_end, m_scores, m_labels = targets
        score_v = pointwise(self.fc_video_score, v)[..., 0]
        score_x = pointwise(self.fc_text_score, x)[..., 0]
        k_max = max(1, -(-(t - 1) // 8))
        cls_gt = m_labels.argmax(dim=2)
        with torch.no_grad():
            pred_v = prec.linear(v, self.fc_video_cls.weight, self.fc_video_cls.bias).argmax(2)
            pred_x = prec.linear(x, self.fc_text_cls.weight, self.fc_text_cls.bias).argmax(2)
        kv = contrastive_candidates(score_v, v, mask, m_start_end, pred_v, cls_gt, k_max)
        kx = contrastive_candidates(score_x, x, mask, m_start_end, pred_x, cls_gt, k_max)
        mf = mask.float()
        aux = {"cls_video": cls_v, "cls_text": cls_x, "key_video": kv[0], "key_text": kx[0],
               "key_any": kv[1], "nonkey_video": kv[2], "nonkey_video_valid": kv[3],
               "nonkey_text": kx[2], "nonkey_text_valid": kx[3],
               "score_loss_video": focal_score_loss(score_v, m_scores, mf),
               "score_loss_text": focal_score_loss(score_x, m_scores, mf)}
        return v, x, aux


class LogitScale(nn.Module):
    def __init__(self):
        super().__init__()
        self.logit_scale = nn.Parameter(torch.empty(()))


class Contrastive(nn.Module):
    """Inter-sample CLIP loss and intra-sample NCE over the whole batch."""

    def __init__(self):
        super().__init__()
        self.logit_scale_inter = nn.Parameter(torch.empty(()))
        self.NCE_video, self.NCE_text = LogitScale(), LogitScale()

    def forward(self, aux, row_valid):
        rv = row_valid
        n_real = rv.float().sum().clamp(min=1.0)
        cv = F.normalize(aux["cls_video"], dim=-1, eps=1e-12)
        ct = F.normalize(aux["cls_text"], dim=-1, eps=1e-12)
        logits = self.logit_scale_inter.exp() * prec.matmul(cv, ct.T)
        logits = logits.masked_fill(~(rv[None, :] & rv[:, None]), NEG)
        eye = torch.eye(rv.shape[0], dtype=torch.bool, device=logits.device)
        logits = logits.masked_fill(eye & ~rv[:, None], 0.0)
        zero = torch.zeros((), device=logits.device)
        inter = (-torch.where(rv, logits.log_softmax(1).diagonal(), zero).sum()
                 - torch.where(rv, logits.T.log_softmax(1).diagonal(), zero).sum()) / 2.0

        def nce(q, k, negs, neg_valid, scale):
            qn, kn, negn = (F.normalize(a, dim=-1) for a in (q, k, negs))
            l_pos = (qn * kn).sum(-1, keepdim=True)
            l_neg = prec.einsum("bc,bkc->bk", qn, negn)
            lg = torch.cat([l_pos, l_neg], 1) * scale
            valid = torch.cat([torch.ones_like(neg_valid[:, :1]), neg_valid], 1)
            lg = lg.masked_fill(~valid, NEG)
            return torch.logsumexp(lg, 1) - lg[:, 0]

        lv = nce(aux["key_video"], aux["key_text"], aux["nonkey_video"],
                 aux["nonkey_video_valid"], self.NCE_video.logit_scale)
        lt = nce(aux["key_text"], aux["key_video"], aux["nonkey_text"],
                 aux["nonkey_text_valid"], self.NCE_text.logit_scale)
        per = (lv + lt) / 2.0 * aux["key_any"].float() * rv.float()
        return inter, per.sum() / n_real


class Detector(nn.Module):
    """The whole model; `forward` returns per-level cls logits (B, T_l, C),
    offsets (B, T_l, C, 2) and masks, and with targets the auxiliary
    losses."""

    def __init__(self, m: Dict):
        super().__init__()
        c, classes = m["embd_dim"], m["num_classes"]
        arch = tuple(m["backbone_arch"])
        assert m["class_aware"] and not m["use_dependency"] and m["use_abs_pe"]
        assert m["input_dim_V"] == m["input_dim_A"] == c == m["head_dim"]
        self.classes = classes
        self.alignment = Alignment(m["raw_input_dim_V"], m["raw_input_dim_A"], c, classes)
        self.backbone = Backbone(c, c, c, m["n_head"], m["max_seq_len"], arch,
                                 m["train_cfg"]["droppath"])
        self.cls_head = ClsHead(2 * c, c, classes, m["head_num_layers"])
        self.reg_head = RegHead(2 * c, c, classes, arch[2] + 1, m["head_num_layers"])
        self.contrastive_losses = Contrastive()

    def n_drops(self) -> int:
        return 4 * len(self.backbone.self_att_V)

    def forward(self, batch, targets=None, drops=None, ckpt=False):
        mask = batch["mask"]
        v, a, aux = self.alignment(batch["visual"], batch["audio"], mask, targets, ckpt)
        fv, fa, masks = self.backbone(v, a, mask, drops, ckpt)
        feats = [torch.cat([x, y], -1) for x, y in zip(fv, fa)]
        cls = self.cls_head(feats, masks)
        off = [o.reshape(o.shape[0], o.shape[1], self.classes, 2)
               for o in self.reg_head(feats, masks)]
        out = {"cls_logits": cls, "offsets": off, "masks": masks}
        if targets is not None:
            inter, intra = self.contrastive_losses(aux, mask.any(dim=1))
            out.update(inter_loss=inter, intra_loss=intra,
                       score_loss_video=aux["score_loss_video"],
                       score_loss_text=aux["score_loss_text"])
        return out


def stem_drops(generator: torch.Generator, batch: int, n: int, p: float, device
               ) -> List[torch.Tensor]:
    """The stochastic-depth multipliers floor(keep + u) / keep, (B, 1, 1)
    each, drawn one row per video in the port's order (attn, mlp; V block,
    A block; block by block)."""
    keep = 1.0 - p
    return [torch.floor(keep + torch.rand((batch, 1, 1), generator=generator, device=device))
            / keep for _ in range(n)]


def fold_in(seed: int, data: int) -> int:
    """The 63-bit seed of the stream (seed, step) that the train step draws
    its stochastic depth from."""
    return ((seed & 0x7FFFFFFF) << 32) | (data & 0xFFFFFFFF)


def build(m: Dict, device="cpu") -> Detector:
    with torch.device("meta"):
        model = Detector(m)
    return model.to_empty(device=device)


def generate_points(seq_len: int, regression_range: Sequence, scale_factor: int = 2):
    out = []
    for level, (lo, hi) in enumerate(regression_range):
        stride = scale_factor ** level
        t = np.arange(0, seq_len, stride, dtype=np.float32)
        out.append(np.stack([t, np.full_like(t, lo), np.full_like(t, hi),
                             np.full_like(t, stride)], axis=1))
    return out
