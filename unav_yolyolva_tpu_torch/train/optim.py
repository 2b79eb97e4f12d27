"""AdamW with a global-norm clip, the reference's decay partition and its
per-iteration warmup schedules.

Numerically the JAX package's `flat_adamw` / optax
`chain(clip_by_global_norm, adamw)`:
  * the clip is g if ||g|| < clip else g * clip / ||g|| (no epsilon on the
    norm, unlike torch's clip_grad_norm_);
  * moments, optax's bias correction and the masked, decoupled weight decay
    are torch.optim.AdamW's, with its lr set from the schedule before every
    update; the first update uses schedule(0) = 0;
  * decay/no-decay follows the flax parameter path of each torch key (the
    port's key map, utils/convert.py), since torch names cannot tell a conv
    `weight` from a channel-LayerNorm `weight`. The reference's quirks:
    inside the `alignment` subtree EVERYTHING except biases decays (its
    position embeddings, CLS/type tokens and LayerNorm scales too), and the
    `contrastive` logit scales never decay.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.convert import build_key_map


def decay_rule(flax_path: Tuple[str, ...]) -> bool:
    """True where weight decay applies to the flax parameter at this path."""
    leaf = flax_path[-1]
    if any("contrastive" in n for n in flax_path):
        return False
    if any("alignment" in n for n in flax_path):
        return leaf != "bias"
    # conv/dense kernels decay; biases, LayerNorm weight/bias and the
    # Scale/AffineDropPath scales do not
    return leaf in ("kernel", "match_projection_kernel")


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """{parameter name: decays} for every parameter of the detector."""
    arch = model.backbone.arch
    with_droppath = any("drop_path" in n for n, _ in model.named_parameters())
    paths = {key: path for key, path, _ in build_key_map(arch, with_droppath)}
    return {name: decay_rule(paths[name]) for name, _ in model.named_parameters()}


def make_schedule(opt_cfg: Dict, num_iters_per_epoch: int) -> Callable[[int], float]:
    """Learning rate of optimizer step `step` (0-based), stepping per
    iteration: linear warmup base * step / (warmup - 1), then cosine to
    eta_min (or multistep decays). Computed in float32 like the JAX
    package's closed form."""
    f = np.float32
    base_lr = opt_cfg["learning_rate"]
    eta_min = opt_cfg.get("eta_min", 1e-8)
    if not opt_cfg.get("warmup", True):
        raise NotImplementedError("schedules without warmup are not ported")
    warmup_steps = opt_cfg["warmup_epochs"] * num_iters_per_epoch
    max_steps = (opt_cfg["epochs"] + opt_cfg["warmup_epochs"]) * num_iters_per_epoch

    def warm(step):
        return np.minimum(f(base_lr) * step / f(max(warmup_steps - 1, 1)), f(base_lr))

    if opt_cfg["schedule_type"] == "cosine":
        def schedule(step: int) -> float:
            step = f(step)
            prog = np.clip((step - f(warmup_steps)) / f(max(max_steps - warmup_steps, 1)),
                           f(0.0), f(1.0))
            cos = f(eta_min) + f(0.5 * (base_lr - eta_min)) * (f(1.0) + np.cos(f(np.pi) * prog))
            return float(warm(step) if step < warmup_steps else cos)
        return schedule

    if opt_cfg["schedule_type"] == "multistep":
        steps = [num_iters_per_epoch * s for s in opt_cfg["schedule_steps"]]
        gamma = opt_cfg["schedule_gamma"]

        def schedule(step: int) -> float:
            step = f(step)
            decays = sum(f(step - warmup_steps >= s) for s in steps)
            stepped = f(base_lr) * f(gamma) ** f(decays)
            return float(warm(step) if step < warmup_steps else stepped)
        return schedule
    raise TypeError(f"unsupported schedule {opt_cfg['schedule_type']}")


class ClippedAdamW:
    """Global-norm clip + torch.optim.AdamW with a decay mask and a schedule.

    zero_grad() drops the grads, so that backward assigns them instead of
    adding into zeros; step() gives a zero grad to every parameter that
    backward left without one (the Alignment's argmax-only class heads), so
    that AdamW still applies its weight decay, as the JAX update does for a
    zero grad. On CUDA the update is torch's fused AdamW (one launch over
    all tensors instead of a chain per chunk of tensors)."""

    def __init__(self, model: nn.Module, schedule: Callable[[int], float],
                 weight_decay: float, clip_norm: float = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        mask = decay_mask(model)
        named = list(model.named_parameters())
        self.params = [p for _, p in named]
        groups = [{"params": [p for n, p in named if mask[n]], "weight_decay": weight_decay},
                  {"params": [p for n, p in named if not mask[n]], "weight_decay": 0.0}]
        fused = all(p.is_cuda for p in self.params)
        self.inner = torch.optim.AdamW(groups, lr=0.0, betas=(b1, b2), eps=eps,
                                       fused=fused or None)
        self.schedule, self.clip_norm, self.count = schedule, clip_norm, 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.clip_norm > 0:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            factor = torch.where(norm < self.clip_norm, torch.ones_like(norm),
                                 self.clip_norm / norm)
            torch._foreach_mul_(grads, factor)
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1

    def state_dict(self) -> Dict:
        return {"count": self.count, "adamw": self.inner.state_dict()}

    def load_state_dict(self, sd: Dict) -> None:
        self.count = int(sd["count"])
        self.inner.load_state_dict(sd["adamw"])


def make_optimizer(model: nn.Module, opt_cfg: Dict, num_iters_per_epoch: int,
                   clip_grad_l2norm: float = 1.0):
    """(optimizer, schedule) for the detector: AdamW only."""
    if opt_cfg["type"] != "AdamW":
        raise NotImplementedError(f"optimizer {opt_cfg['type']} is not ported")
    schedule = make_schedule(opt_cfg, num_iters_per_epoch)
    return ClippedAdamW(model, schedule, opt_cfg["weight_decay"], clip_grad_l2norm), schedule
