"""LocPointTransformer: Alignment -> backbone (fusion pyramid) -> per-level
concat(V, A) -> the optional dependency block -> cls/reg heads, plus the contrastive and score losses the
forward reports, and `compute_losses`, the train loss assembly.

`compute_dtype` (config `tpu.compute_dtype`, "float32" or "bfloat16") is
the JAX package's compute policy: parameters stay fp32; under bfloat16 the
Alignment, backbone and head towers compute in bf16 (module by module, as
the JAX modules' `dtype=`), while LayerNorm statistics, softmax, the stem's
residual stream, the head logits and offsets, the dependency block (which
has no dtype) and every loss stay fp32."""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import resolve_device
from ..core.registry import DEPENDENCY_BLOCKS
from ..ops.losses import ctr_diou_loss_1d, diou_pair_weights, sigmoid_focal_loss
from ..parallel.collectives import all_reduce_sum, gather_rows
from ..parallel.mesh import draws_for
from ..utils.profiling import span
from .alignment import Alignment
from .backbone import ConvTransformerBackbone
from .blocks import AffineDropPath, ChannelLayerNorm, Conv1x1, LearnableScale
from .dependency import DependencyBlock  # noqa: F401  (registers itself)
from .fusion import MaxSigmoidAttnBlock
from .heads import ClsHead, RegHead, cls_prior_bias

LOGIT_SCALE_INIT = math.log(1.0 / 0.07)


class _LogitScale(nn.Module):
    def __init__(self):
        super().__init__()
        self.logit_scale = nn.Parameter(torch.empty(()))


class ContrastiveLosses(nn.Module):
    """Inter-sample CLIP loss (times exp(logit_scale_inter)) and intra-sample
    NCE (times the RAW per-modality scale, a reference quirk). Zero-padded
    eval rows (row_valid False) are left out of both.

    With a data-parallel `mesh` the rows are the rank's block of the global
    batch and the losses are its shares of the global ones: the inter loss
    takes every rank's CLS embeddings (gathered with their gradient) as
    negatives and sums the v->t rows of its own videos and the t->v rows of
    its own audio tracks at their global diagonal; the intra NCE divides by
    the global count of real rows. The shares summed over the ranks are the
    losses of the whole batch."""

    def __init__(self):
        super().__init__()
        self.logit_scale_inter = nn.Parameter(torch.empty(()))
        self.NCE_video = _LogitScale()
        self.NCE_text = _LogitScale()

    def forward(self, aux: Dict[str, torch.Tensor], mesh=None):
        rv = aux["row_valid"]
        b = rv.shape[0]
        lo = b * mesh.rank if mesh is not None else 0
        cls_v = gather_rows(F.normalize(aux["cls_video"], dim=-1, eps=1e-12), mesh)
        cls_t = gather_rows(F.normalize(aux["cls_text"], dim=-1, eps=1e-12), mesh)
        rv_all = gather_rows(rv, mesh)
        n_real = all_reduce_sum(rv.float().sum(), mesh).clamp(min=1.0)
        neg = torch.finfo(torch.float32).min
        logits = self.logit_scale_inter.exp() * (cls_v @ cls_t.T)
        logits = logits.masked_fill(~(rv_all[None, :] & rv_all[:, None]), neg)
        eye = torch.eye(rv_all.shape[0], dtype=torch.bool, device=logits.device)
        logits = logits.masked_fill(eye & ~rv_all[:, None], 0.0)
        diag_v = logits.log_softmax(dim=1).diagonal()[lo:lo + b]
        diag_t = logits.T.log_softmax(dim=1).diagonal()[lo:lo + b]
        zero = torch.zeros((), device=logits.device)
        inter = (-torch.where(rv, diag_v, zero).sum()
                 - torch.where(rv, diag_t, zero).sum()) / 2.0

        def nce(q, k, negs, neg_valid, scale):
            qn, kn = F.normalize(q, dim=-1), F.normalize(k, dim=-1)
            negn = F.normalize(negs, dim=-1)
            l_pos = (qn * kn).sum(dim=-1, keepdim=True)
            l_neg = torch.einsum("bc,bkc->bk", qn, negn)
            lg = torch.cat([l_pos, l_neg], dim=1) * scale
            valid = torch.cat([torch.ones_like(neg_valid[:, :1]), neg_valid], dim=1)
            lg = lg.masked_fill(~valid, neg)
            return torch.logsumexp(lg, dim=1) - lg[:, 0]

        loss_v = nce(aux["key_video"], aux["key_text"], aux["nonkey_video"],
                     aux["nonkey_video_valid"], self.NCE_video.logit_scale)
        loss_t = nce(aux["key_text"], aux["key_video"], aux["nonkey_text"],
                     aux["nonkey_text_valid"], self.NCE_text.logit_scale)
        per_sample = (loss_v + loss_t) / 2.0 * aux["key_any"].float() * rv.float()
        return inter, per_sample.sum() / n_real


class LocPointTransformer(nn.Module):
    def __init__(self, raw_input_dim_V: int = 2048, raw_input_dim_A: int = 128,
                 input_dim_V: int = 512, input_dim_A: int = 512,
                 num_classes: int = 100, max_seq_len: int = 224,
                 backbone_arch=(2, 3, 5), scale_factor: int = 2, n_head: int = 4,
                 embd_kernel_size: int = 3, embd_dim: int = 512,
                 embd_with_ln: bool = True, head_dim: int = 512,
                 head_kernel_size: int = 3, head_num_layers: int = 3,
                 head_with_ln: bool = True, use_abs_pe: bool = True,
                 class_aware: bool = True, cls_prior_prob: float = 0.01,
                 droppath: float = 0.1, head_empty_cls=(), use_dependency: bool = False,
                 dependency_type: str = "DependencyBlock",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes, self.class_aware = num_classes, class_aware
        self.compute_dtype = compute_dtype
        dt = None if compute_dtype == torch.float32 else compute_dtype
        self.alignment = Alignment(raw_input_dim_V, raw_input_dim_A, embd_dim,
                                   num_classes=num_classes, dtype=dt)
        self.backbone = ConvTransformerBackbone(
            input_dim_V, input_dim_A, embd_dim, n_head, embd_kernel_size,
            max_seq_len, backbone_arch, scale_factor, embd_with_ln, droppath,
            use_abs_pe, dtype=dt)
        self.cls_head = ClsHead(2 * embd_dim, head_dim, num_classes,
                                cls_prior_prob, head_num_layers, head_kernel_size,
                                head_with_ln, head_empty_cls, dtype=dt)
        self.reg_head = RegHead(2 * embd_dim, head_dim, num_classes,
                                backbone_arch[2] + 1, head_num_layers,
                                head_kernel_size, head_with_ln, class_aware, dtype=dt)
        self.contrastive_losses = ContrastiveLosses()
        # after every other module: its draws in init_weights come last
        self.dependency = (DEPENDENCY_BLOCKS.build(
            dependency_type, in_channel=2 * embd_dim, n_embd=128,
            n_embd_ks=embd_kernel_size, num_classes=num_classes, path_pdrop=droppath)
            if use_dependency else None)

    def forward(self, batch: Dict[str, torch.Tensor], with_losses: bool = True,
                generator: Optional[torch.Generator] = None, mesh=None):
        """batch: visual (B, T, Dv), audio (B, T, Da), mask (B, T) bool and,
        with losses, the frame targets m_start_end, m_scores, m_labels.
        In training mode `generator` draws the stochastic depth. With a
        data-parallel `mesh` (parallel/mesh.py) the batch is the rank's row
        block of the global batch: the stochastic depth takes its rows of
        the global draw, and the losses are its shares of the global ones.
        Spans (utils/profiling.py): `unav.model.alignment`,
        `unav.model.backbone` (the stem, the downsampling, the fusion pyramid
        and the per-level concat), `unav.model.dependency` (the dependency
        block, where there is one) and `unav.model.heads`."""
        generator = draws_for(generator, mesh)
        mask = batch["mask"]
        targets = ((batch["m_start_end"], batch["m_scores"], batch["m_labels"])
                   if with_losses else None)
        with span("unav.model.alignment"):
            v_al, a_al, aux = self.alignment(batch["visual"], batch["audio"], mask,
                                             mask, targets)
        with span("unav.model.backbone"):
            feats_v, feats_a, masks = self.backbone(v_al, a_al, mask, generator)
            feats = [torch.cat([fv, fa], dim=-1) for fv, fa in zip(feats_v, feats_a)]
        if self.dependency is not None:
            with span("unav.model.dependency"):
                feats, masks = self.dependency(feats, masks, generator)
        with span("unav.model.heads"):
            cls_logits = self.cls_head(feats, masks)
            offsets = self.reg_head(feats, masks)
            if self.class_aware:
                offsets = [o.reshape(o.shape[0], o.shape[1], self.num_classes, 2)
                           for o in offsets]
        out = {"cls_logits": cls_logits, "offsets": offsets, "masks": masks}
        if with_losses:
            aux["row_valid"] = mask.any(dim=1)
            inter, intra = self.contrastive_losses(aux, mesh)
            out.update(inter_loss=inter, intra_loss=intra,
                       score_loss_video=aux["score_loss_video"],
                       score_loss_text=aux["score_loss_text"])
        return out


def compute_losses(outputs: Dict[str, Any], gt_cls: torch.Tensor, gt_offsets: torch.Tensor,
                   loss_normalizer: torch.Tensor, *, class_aware: bool = True,
                   loss_weight: float = 1.0, inter_weight: float = 0.001,
                   intra_weight: float = 1.0, score_v_weight: float = 0.001,
                   score_a_weight: float = 0.001, label_smoothing: float = 0.0,
                   normalizer_momentum: float = 0.9, mesh=None):
    """Loss assembly, sum-reduced, of the forward's outputs against dense
    targets gt_cls (B, P, C) and gt_offsets (B, P, C, 2) or (B, P, 2).

    Reference quirks kept: every reported loss is divided by the NUMBER OF
    PYRAMID LEVELS (the reference's `B = len(fpn_masks)`), not the batch;
    the normalizer is an EMA (momentum 0.9) of max(num_pos, 1); with
    loss_weight <= 0 the reg weight is cls/reg of the detached losses; the
    reg loss is 0 without positives. Returns (losses, new_normalizer).

    With a data-parallel `mesh` the inputs are the rank's rows: num_pos is
    summed over the ranks before the normalizer's EMA (every rank keeps the
    same normalizer), the reg weight of loss_weight <= 0 is taken from the
    global cls and reg losses, and every loss is the rank's share of the
    global one (parallel/collectives.py:sum_losses adds them up); num_pos
    is the global count."""
    num_classes = gt_cls.shape[-1]
    level_div = float(len(outputs["masks"]))
    valid_mask = torch.cat(outputs["masks"], dim=1)                  # (B, P)
    cls_logits = torch.cat(outputs["cls_logits"], dim=1)             # (B, P, C)
    pred_offsets = torch.cat(outputs["offsets"], dim=1)

    pos_mask = (gt_cls.sum(dim=-1) > 0) & valid_mask
    num_pos = all_reduce_sum(pos_mask.sum(), mesh)
    new_normalizer = normalizer_momentum * loss_normalizer + (
        1.0 - normalizer_momentum) * num_pos.float().clamp(min=1.0)

    gt_target = gt_cls * (1.0 - label_smoothing) + label_smoothing / (num_classes + 1)
    cls_loss = sigmoid_focal_loss(cls_logits, gt_target, reduction="sum",
                                  weights=valid_mask[..., None].float()) / new_normalizer
    if class_aware:
        reg_w = pos_mask[..., None].float() * diou_pair_weights(gt_offsets)
    else:
        reg_w = pos_mask.float()
    reg_raw = ctr_diou_loss_1d(pred_offsets, gt_offsets, reduction="sum", weights=reg_w)
    reg_loss = torch.where(num_pos > 0, reg_raw / new_normalizer, torch.zeros_like(reg_raw))

    if loss_weight > 0:
        w = loss_weight
    else:
        cls_all, reg_all = all_reduce_sum(torch.stack([cls_loss.detach(), reg_loss.detach()]),
                                          mesh)
        w = cls_all / reg_all.clamp(min=0.01)

    inter, intra = outputs["inter_loss"], outputs["intra_loss"]
    score_v, score_t = outputs["score_loss_video"], outputs["score_loss_text"]
    final = (cls_loss + reg_loss * w + inter * inter_weight + intra * intra_weight
             + score_v * score_v_weight + score_t * score_a_weight)
    losses = {
        "cls_loss": cls_loss / level_div,
        "reg_loss": (reg_loss * w) / level_div,
        "inter_contr_loss": (inter * inter_weight) / level_div,
        "intra_contr_loss": (intra * intra_weight) / level_div,
        "score_loss_video": (score_v * score_v_weight) / level_div,
        "score_loss_audio": (score_t * score_a_weight) / level_div,
        "final_loss": final / level_div,
        "num_pos": num_pos,
    }
    return losses, new_normalizer


@torch.no_grad()
def init_weights(model: LocPointTransformer, generator: torch.Generator) -> None:
    """Random weights drawn from `generator`, with the distributions of the
    JAX package's initializers: torch-default uniform convs/dense (zero
    bias), trunc-normal(0.02) in the Alignment, LayerNorms at 1/0, the focal
    prior on the cls bias, AffineDropPath 1e-4, Scale 1, logit scales
    log(1/0.07)."""
    def uniform(w, fan_in):
        bound = 1.0 / math.sqrt(max(fan_in, 1))
        nn.init.uniform_(w, -bound, bound, generator=generator)

    def trunc_normal(w):
        nn.init.trunc_normal_(w, 0.0, 0.02, -2.0, 2.0, generator=generator)

    for name, mod in model.named_modules():
        if isinstance(mod, nn.Conv1d):
            uniform(mod.weight, mod.weight.shape[1] * mod.weight.shape[2])
        elif isinstance(mod, Conv1x1):
            uniform(mod.weight, mod.weight.shape[1])
        elif isinstance(mod, nn.Linear):
            if name.startswith("alignment."):
                trunc_normal(mod.weight)
            else:
                uniform(mod.weight, mod.weight.shape[1])
        elif isinstance(mod, (nn.LayerNorm, ChannelLayerNorm)):
            mod.weight.fill_(1.0)
        elif isinstance(mod, AffineDropPath):
            mod.scale.fill_(1e-4)
        elif isinstance(mod, LearnableScale):
            mod.scale.fill_(1.0)
        elif isinstance(mod, MaxSigmoidAttnBlock):
            mod.bias.zero_()
        elif isinstance(mod, Alignment):
            for p in (mod.cls_token_video, mod.cls_token_text, mod.pos_embed_video,
                      mod.pos_embed_text, mod.type_video, mod.type_text):
                trunc_normal(p)
        elif isinstance(mod, (ContrastiveLosses, _LogitScale)):
            for p in mod.parameters(recurse=False):
                p.fill_(LOGIT_SCALE_INIT)
        if isinstance(mod, (nn.Conv1d, Conv1x1, nn.Linear, nn.LayerNorm,
                            ChannelLayerNorm)) and mod.bias is not None:
            mod.bias.zero_()
    head = model.cls_head
    head.cls_head.conv.bias.copy_(cls_prior_bias(head.prior_prob,
                                                 head.cls_head.conv.out_channels,
                                                 head.empty_cls))


def build_model(cfg: Dict[str, Any], device=None, seed: Optional[int] = 0
                ) -> LocPointTransformer:
    """The detector of a full config dict, in eval mode on `device` (CUDA
    unless the caller asks for the CPU), computing in `tpu.compute_dtype`
    (one of core/config.py:COMPUTE_DTYPES) with fp32 parameters. Weights are drawn on the CPU from `seed`, so they
    do not depend on the device; seed=None leaves them uninitialized (for
    load_state_dict)."""
    device = resolve_device(device)
    m = cfg["model"]
    with torch.device("meta"):
        model = LocPointTransformer(
            raw_input_dim_V=m.get("raw_input_dim_V", 2048),
            raw_input_dim_A=m.get("raw_input_dim_A", 128),
            input_dim_V=m["input_dim_V"], input_dim_A=m["input_dim_A"],
            num_classes=m["num_classes"], max_seq_len=m["max_seq_len"],
            backbone_arch=tuple(m["backbone_arch"]),
            scale_factor=m["scale_factor"], n_head=m["n_head"],
            embd_kernel_size=m["embd_kernel_size"], embd_dim=m["embd_dim"],
            embd_with_ln=m["embd_with_ln"], head_dim=m["head_dim"],
            head_kernel_size=m["head_kernel_size"],
            head_num_layers=m["head_num_layers"],
            head_with_ln=m["head_with_ln"], use_abs_pe=m["use_abs_pe"],
            class_aware=m["class_aware"],
            cls_prior_prob=m["train_cfg"]["cls_prior_prob"],
            droppath=m["train_cfg"]["droppath"],
            head_empty_cls=tuple(m["train_cfg"]["head_empty_cls"]),
            use_dependency=m["use_dependency"],
            dependency_type=m.get("dependency_type", "DependencyBlock"),
            compute_dtype=getattr(torch, cfg["tpu"]["compute_dtype"]),
        )
    model = model.to_empty(device="cpu")
    if seed is not None:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
