"""AdamW or SGD with a global-norm clip, the reference's decay partition and
its per-iteration schedules.

AdamW is numerically the JAX package's `flat_adamw` / optax
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
SGD is `chain(clip_by_global_norm, add_decayed_weights(wd, mask),
sgd(schedule, momentum))`: the clip, then wd * p added to the grad of each
decaying parameter, then the momentum trace g + momentum * trace, which is
torch.optim.SGD's buffer (dampening 0, coupled weight decay).
The schedules: linear warmup then cosine or multistep (`warmup: True`, the
JAX package's closed form), or without warmup optax's
`cosine_decay_schedule` and `piecewise_constant_schedule`.
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
    with_dependency = getattr(model, "dependency", None) is not None
    paths = {key: path for key, path, _ in build_key_map(arch, with_droppath, with_dependency)}
    return {name: decay_rule(paths[name]) for name, _ in model.named_parameters()}


def make_schedule(opt_cfg: Dict, num_iters_per_epoch: int) -> Callable[[int], float]:
    """Learning rate of optimizer step `step` (0-based), stepping per
    iteration. With warmup: linear base * step / (warmup - 1), then cosine
    to eta_min (or multistep decays), the JAX package's closed form. Without:
    optax's cosine_decay_schedule(base, epochs * iters, eta_min / base) or
    piecewise_constant_schedule(base, {iters * s: gamma}), whose boundary
    takes effect AT its step. Computed in float32 as the JAX package does."""
    f = np.float32
    base_lr = opt_cfg["learning_rate"]
    eta_min = opt_cfg.get("eta_min", 1e-8)
    kind = opt_cfg["schedule_type"]
    if kind not in ("cosine", "multistep"):
        raise TypeError(f"unsupported schedule {kind}")
    if not opt_cfg.get("warmup", True):
        return _schedule_without_warmup(kind, opt_cfg, base_lr, eta_min, num_iters_per_epoch)
    warmup_steps = opt_cfg["warmup_epochs"] * num_iters_per_epoch
    max_steps = (opt_cfg["epochs"] + opt_cfg["warmup_epochs"]) * num_iters_per_epoch

    def warm(step):
        return np.minimum(f(base_lr) * step / f(max(warmup_steps - 1, 1)), f(base_lr))

    if kind == "cosine":
        def schedule(step: int) -> float:
            step = f(step)
            prog = np.clip((step - f(warmup_steps)) / f(max(max_steps - warmup_steps, 1)),
                           f(0.0), f(1.0))
            cos = f(eta_min) + f(0.5 * (base_lr - eta_min)) * (f(1.0) + np.cos(f(np.pi) * prog))
            return float(warm(step) if step < warmup_steps else cos)
        return schedule

    steps = [num_iters_per_epoch * s for s in opt_cfg["schedule_steps"]]
    gamma = opt_cfg["schedule_gamma"]

    def schedule(step: int) -> float:
        step = f(step)
        decays = sum(f(step - warmup_steps >= s) for s in steps)
        stepped = f(base_lr) * f(gamma) ** f(decays)
        return float(warm(step) if step < warmup_steps else stepped)
    return schedule


def _schedule_without_warmup(kind: str, opt_cfg: Dict, base_lr: float, eta_min: float,
                             num_iters_per_epoch: int) -> Callable[[int], float]:
    f = np.float32
    if kind == "cosine":
        decay_steps = opt_cfg["epochs"] * num_iters_per_epoch
        if decay_steps <= 0:
            raise ValueError(f"the cosine schedule needs positive decay steps, got {decay_steps}")
        alpha = eta_min / base_lr

        def schedule(step: int) -> float:
            count = f(min(step, decay_steps))
            cos = f(0.5) * (f(1.0) + np.cos(f(np.pi) * count / f(decay_steps)))
            return float(f(base_lr) * (f(1.0 - alpha) * cos + f(alpha)))
        return schedule

    # a dict as in the JAX package: equal boundaries collapse into one
    bounds = sorted({num_iters_per_epoch * s: opt_cfg["schedule_gamma"]
                     for s in opt_cfg["schedule_steps"]}.items())

    def schedule(step: int) -> float:
        v = f(base_lr)
        for threshold, scale in bounds:
            if step >= threshold:
                v = f(scale) * v
        return float(v)
    return schedule


class ClippedOptimizer:
    """Global-norm clip + a torch optimizer (AdamW or SGD) over two groups,
    decaying and not, with its lr set from the schedule before each update.

    zero_grad() drops the grads, so that backward assigns them instead of
    adding into zeros (the train step's CUDA graph calls it once, before its
    capture, and its replays overwrite the grads it assigned); step() gives
    a zero grad to every parameter that backward left without one (the
    Alignment's argmax-only class heads), so that the weight decay still
    applies, as the JAX update does for a zero grad. `count` is the number
    of updates taken (optax's count)."""

    def __init__(self, model: nn.Module, make_inner: Callable, schedule: Callable[[int], float],
                 weight_decay: float, clip_norm: float = 1.0):
        mask = decay_mask(model)
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        groups = [{"params": [p for n, p in named if mask[n]], "weight_decay": weight_decay},
                  {"params": [p for n, p in named if not mask[n]], "weight_decay": 0.0}]
        self.inner = make_inner(groups, all(p.is_cuda for p in self.params))
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
        return {"count": self.count, self.KEY: self.inner.state_dict()}

    def load_state_dict(self, sd: Dict) -> None:
        self.count = int(sd["count"])
        self.inner.load_state_dict(sd[self.KEY])

    def load_jax_state(self, kind: str, count: int,
                       moments: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Take a JAX optimizer state as utils/convert.py:opt_state_from_jax
        gives it: (kind, count, {moment name: {parameter name: tensor}})."""
        if kind != self.KEY:
            raise ValueError(f"a JAX {kind} optimizer state cannot resume {self.KEY}")
        self.count = count
        for name, p in zip(self.names, self.params):
            st = {k: v[name].to(device=p.device, dtype=p.dtype).clone()
                  for k, v in moments.items()}
            self.inner.state[p] = self._extra_state(st, count, p)

    def _extra_state(self, st: Dict, count: int, p: torch.Tensor) -> Dict:
        return st


class ClippedAdamW(ClippedOptimizer):
    """The clip + torch.optim.AdamW (optax's moments and bias correction,
    masked decoupled weight decay). On CUDA the update is torch's fused
    AdamW: one launch over all tensors instead of a chain per chunk."""

    KEY = "adamw"

    def __init__(self, model: nn.Module, schedule: Callable[[int], float],
                 weight_decay: float, clip_norm: float = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        super().__init__(model, lambda groups, cuda: torch.optim.AdamW(
            groups, lr=0.0, betas=(b1, b2), eps=eps, fused=cuda or None),
            schedule, weight_decay, clip_norm)

    def _extra_state(self, st: Dict, count: int, p: torch.Tensor) -> Dict:
        # AdamW's step: a float32 scalar, on the card for the fused update
        fused = bool(self.inner.param_groups[0].get("fused"))
        st["step"] = torch.tensor(float(count), dtype=torch.float32,
                                  device=p.device if fused else "cpu")
        return st


class ClippedSGD(ClippedOptimizer):
    """The clip + torch.optim.SGD with momentum: its coupled weight decay
    (wd * p added to the grad before the momentum) is optax's
    add_decayed_weights before sgd, and its buffer optax's trace."""

    KEY = "sgd"

    def __init__(self, model: nn.Module, schedule: Callable[[int], float],
                 weight_decay: float, clip_norm: float = 1.0, momentum: float = 0.9):
        super().__init__(model, lambda groups, cuda: torch.optim.SGD(
            groups, lr=0.0, momentum=momentum), schedule, weight_decay, clip_norm)


def make_optimizer(model: nn.Module, opt_cfg: Dict, num_iters_per_epoch: int,
                   clip_grad_l2norm: float = 1.0):
    """(optimizer, schedule) for the detector: AdamW or SGD."""
    schedule = make_schedule(opt_cfg, num_iters_per_epoch)
    wd = opt_cfg["weight_decay"]
    if opt_cfg["type"] == "AdamW":
        return ClippedAdamW(model, schedule, wd, clip_grad_l2norm), schedule
    if opt_cfg["type"] == "SGD":
        return ClippedSGD(model, schedule, wd, clip_grad_l2norm, opt_cfg["momentum"]), schedule
    raise TypeError(f"unsupported optimizer {opt_cfg['type']}")
