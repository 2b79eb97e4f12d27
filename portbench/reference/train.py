"""The plain float32 reference of one train step: dense targets from the
padded events, the training forward with stochastic depth, the losses, the
backward, the global-norm clip, AdamW at the schedule's rate with the
reference's decay partition, the EMA and the loss normalizer's EMA.

A frozen, stand-alone copy of the port's plain path (targets, losses,
optimizer and EMA), written to stand alone. The stochastic depth is drawn
again from the step's seed and the step count (`model.fold_in`), in the
order the program draws it; the loss normalizer is worked out again from
the state handed in.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from . import model as ref_model

FRAME_TARGET_DIVISOR = 1.28


def assign_labels(points, seg, labels, valid, classes):
    """Class-aware center-sampling assignment: (B, P, C) multi-hot and the
    (B, P, C, 2) offsets of the last matching event of each class, over the
    point's stride."""
    t = points[:, 0][None, :, None]
    seg = seg.float()
    left, right = t - seg[:, None, :, 0], seg[:, None, :, 1] - t
    max_dist = torch.maximum(left, right)
    ok = ((torch.minimum(left, right) > 0) & (max_dist >= points[:, 1][None, :, None])
          & (max_dist <= points[:, 2][None, :, None]) & valid[:, None, :])
    one_hot = F.one_hot(labels.long(), classes).float() * valid[..., None].float()
    cls_t = (ok.float() @ one_hot).clamp(0.0, 1.0)
    n = seg.shape[1]
    idx_ok = torch.where(ok, torch.arange(n, device=seg.device)[None, None, :],
                         torch.full_like(ok, -1, dtype=torch.long))
    j = torch.full(cls_t.shape, -1, dtype=torch.long, device=seg.device).scatter_reduce(
        2, labels.long()[:, None, :].expand_as(idx_ok), idx_ok, reduce="amax")
    sel = seg[torch.arange(seg.shape[0], device=seg.device)[:, None, None], j.clamp(min=0)]
    reg = torch.stack([t - sel[..., 0], sel[..., 1] - t], dim=-1)
    return cls_t, reg * (j >= 0)[..., None].float() / points[:, 3][None, :, None, None]


def frame_targets(seg, labels, valid, seq_len, classes):
    """Per-frame (B, T) scores, (B, T) start_end, (B, T, C) labels, with the
    reference collate's grid / 1.28 divisor."""
    start = torch.trunc(seg[..., 0].float() / FRAME_TARGET_DIVISOR).int().clamp(min=0)
    end = torch.trunc(seg[..., 1].float() / FRAME_TARGET_DIVISOR).int()
    t = torch.arange(seq_len, device=seg.device, dtype=torch.int32)[None, :, None]
    v = valid[:, None, :]
    after = t >= start[:, None, :]
    in_score = after & (t < end[:, None, :]) & v
    in_se = after & (t <= end[:, None, :]) & v
    n = seg.shape[1]
    j = torch.where(in_score, torch.arange(n, device=seg.device),
                    torch.full_like(in_score, -1, dtype=torch.long)).amax(dim=2)
    lab = F.one_hot(labels.long().gather(1, j.clamp(min=0)), classes).float() \
        * (j >= 0)[..., None].float()
    return in_score.any(2).float(), in_se.any(2).float(), lab


def focal_loss(logits, targets, weights, alpha=0.25, gamma=2.0):
    p = torch.sigmoid(logits)
    ce = logits.clamp(min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    loss = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * loss
    return (loss * weights).sum()


def diou_loss(pred, target, weights, eps=1e-8):
    lp, rp, lg, rg = pred[..., 0], pred[..., 1], target[..., 0], target[..., 1]
    inter = torch.minimum(rp, rg) + torch.minimum(lp, lg)
    union = (lp + rp) + (lg + rg) - inter
    iou = inter / union.clamp(min=eps)
    len_c = torch.maximum(lp, lg) + torch.maximum(rp, rg)
    rho = 0.5 * (rp - lp - rg + lg)
    return ((1.0 - iou + (rho / len_c.clamp(min=eps)) ** 2) * weights).sum()


def losses(out, gt_cls, gt_reg, normalizer, cfg) -> Dict[str, torch.Tensor]:
    """The loss assembly (every loss over the number of pyramid levels, the
    normalizer an EMA of the positive count) and the new normalizer."""
    m, tc = cfg["model"], cfg["train_cfg"]
    levels = float(len(out["masks"]))
    valid = torch.cat(out["masks"], 1)
    logits = torch.cat(out["cls_logits"], 1)
    offsets = torch.cat(out["offsets"], 1)
    pos = (gt_cls.sum(-1) > 0) & valid
    num_pos = pos.sum()
    new_norm = 0.9 * normalizer + 0.1 * num_pos.float().clamp(min=1.0)
    smooth = tc["label_smoothing"]
    target = gt_cls * (1.0 - smooth) + smooth / (gt_cls.shape[-1] + 1)
    cls_loss = focal_loss(logits, target, valid[..., None].float()) / new_norm
    reg_w = pos[..., None].float() * ((gt_reg[..., 0] > 0) | (gt_reg[..., 1] > 0)).float()
    reg_raw = diou_loss(offsets, gt_reg, reg_w)
    reg_loss = torch.where(num_pos > 0, reg_raw / new_norm, torch.zeros_like(reg_raw))
    w = tc["loss_weight"]
    if w <= 0:
        w = cls_loss.detach() / reg_loss.detach().clamp(min=0.01)
    parts = {"cls_loss": cls_loss, "reg_loss": reg_loss * w,
             "inter_contr_loss": out["inter_loss"] * m["inter_contr_weight"],
             "intra_contr_loss": out["intra_loss"] * m["intra_contr_weight"],
             "score_loss_video": out["score_loss_video"] * m["score_V_weight"],
             "score_loss_audio": out["score_loss_text"] * m["score_A_weight"]}
    final = sum(parts.values())
    res = {k: v / levels for k, v in parts.items()}
    res["final_loss"] = final / levels
    return res, new_norm


def decays(name: str) -> bool:
    """The reference's weight-decay partition in the torch key space: inside
    the Alignment everything but biases, never the contrastive logit scales,
    elsewhere the convolution and dense kernels only."""
    leaf = name.rsplit(".", 1)[-1]
    if name.startswith("contrastive_losses."):
        return False
    if name.startswith("alignment."):
        return leaf != "bias"
    is_norm = "norm" in name or any(f".{n}." in name for n in ("ln11", "ln12", "ln2"))
    return leaf == "weight" and not is_norm


def warmup_lr(opt: Dict, count: int, iters_per_epoch: int) -> float:
    """The learning rate of update `count` (0-based) under the linear warmup
    then cosine schedule, in float32."""
    f = np.float32
    base, eta_min = opt["learning_rate"], opt["eta_min"]
    warm = opt["warmup_epochs"] * iters_per_epoch
    total = (opt["epochs"] + opt["warmup_epochs"]) * iters_per_epoch
    step = f(count)
    if step < warm:
        return float(np.minimum(f(base) * step / f(max(warm - 1, 1)), f(base)))
    prog = np.clip((step - f(warm)) / f(max(total - warm, 1)), f(0.0), f(1.0))
    return float(f(eta_min) + f(0.5 * (base - eta_min)) * (f(1.0) + np.cos(f(np.pi) * prog)))


class State:
    """Parameters (the model's), AdamW moments, the EMA copy, the loss
    normalizer and the update count: a run resumed at update `count` with
    zero moments and the EMA at the weights."""

    def __init__(self, model, init_norm: float, count: int = 0):
        self.model = model
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.ema = [p.detach().clone() for p in self.params]
        self.norm = torch.tensor(float(init_norm), device=self.params[0].device)
        self.count = count


def step(state: State, batch: Dict[str, torch.Tensor], seed: int, cfg: Dict,
         iters_per_epoch: int, ckpt: bool = True) -> Dict[str, torch.Tensor]:
    """One update of `state` from a device batch; returns the losses."""
    m, tc, opt = cfg["model"], cfg["train_cfg"], cfg["opt"]
    model, dev = state.model, state.params[0].device
    t, classes = m["max_seq_len"], m["num_classes"]
    points = torch.from_numpy(np.concatenate(ref_model.generate_points(
        t, m["regression_range"], m["scale_factor"]))).to(dev)
    mask, gv = batch["mask"].bool(), batch["gt_valid"].bool()
    m_scores, m_se, m_labels = frame_targets(batch["gt_segments"], batch["gt_labels"], gv, t,
                                             classes)
    gt_cls, gt_reg = assign_labels(points, batch["gt_segments"], batch["gt_labels"], gv,
                                   classes)
    gen = torch.Generator(device=dev).manual_seed(ref_model.fold_in(seed, state.count))
    drops = ref_model.stem_drops(gen, mask.shape[0], model.n_drops(), tc["droppath"], dev)
    model.train()
    out = model({"visual": batch["visual"].float(), "audio": batch["audio"].float(),
                 "mask": mask}, targets=(m_se, m_scores, m_labels), drops=drops, ckpt=ckpt)
    res, new_norm = losses(out, gt_cls, gt_reg, state.norm, cfg)
    for p in state.params:
        p.grad = None
    res["final_loss"].backward()
    with torch.no_grad():
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in state.params]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        factor = torch.where(norm < tc["clip_grad_l2norm"], torch.ones_like(norm),
                             tc["clip_grad_l2norm"] / norm)
        lr = warmup_lr(opt, state.count, iters_per_epoch)
        wd, b1, b2, eps = opt["weight_decay"], 0.9, 0.999, 1e-8
        t1 = state.count + 1
        for name, p, g, mo, ve in zip(state.names, state.params, grads, state.m, state.v):
            g = g * factor
            if decays(name):
                p.mul_(1.0 - lr * wd)
            mo.mul_(b1).add_(g, alpha=1.0 - b1)
            ve.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = (ve / (1.0 - b2 ** t1)).sqrt_().add_(eps)
            p.addcdiv_(mo, denom, value=-lr / (1.0 - b1 ** t1))
        for e, p in zip(state.ema, state.params):
            e.mul_(0.999).add_(p, alpha=0.001)
        state.norm = new_norm.detach()
        state.count += 1
    return {k: v.detach() for k, v in res.items()}


def first_grads(state: State) -> List[torch.Tensor]:
    """The clipped gradient the first update took, from its first moment."""
    return [mo / 0.1 for mo in state.m]
