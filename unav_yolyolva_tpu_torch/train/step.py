"""The train step: a batch of host features and padded ground-truth events
in, one optimizer update out.

In order: the batch's copy to the device (pinned batches on a copy stream
of the step's own, core/device.py:make_batch_copier), dense targets built
on the device (label assignment and the
per-frame targets), the forward in training mode with the stochastic depth
drawn from a generator seeded from (seed, step), the loss assembly, the
backward (through the MHCA and CSP backward kernels of the compute dtype
on CUDA), the global-
norm clip and AdamW update at the scheduled learning rate, the EMA update
and the loss-normalizer EMA. Spans (utils/profiling.py): `unav.train.step`
around the call, and in it `unav.train.forward` (the copy to the losses),
`unav.train.backward` (the grads dropped, the backward) and
`unav.train.update` (the all-reduce, zero grads for the parameters the
backward left without one, clip and AdamW, the EMAs).

Data parallel (a `mesh` from parallel/mesh.py:make_mesh under torchrun):
the batch is the rank's row block of the global batch, the loss is the
rank's share of the global loss (models/meta_arch.py), and after the
backward every gradient is summed over the ranks in one all-reduce of one
flat buffer before the clip (parallel/collectives.py:GradSum), as the JAX program reduces the whole gradient
after its backward. Not DDP: DDP averages where the shares need a sum, and
would need find_unused_parameters for the Alignment's argmax-only class
heads, which get no grad. With a group the all-reduce runs at every world
size, one rank included, where it keeps the bits.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..core.device import make_batch_copier, resolve_device
from ..geometry.assign import assign_labels_batch, frame_targets_batch
from ..geometry.points import concat_points, generate_points
from ..models.meta_arch import compute_losses
from ..parallel.collectives import GradSum, sharded, sum_losses
from ..utils.profiling import span
from ..utils.seed import fold_in
from .ema import ema_update
from .state import TrainState

BATCH_KEYS = ("visual", "audio", "mask", "gt_segments", "gt_labels", "gt_valid")


def build_targets(batch: Dict[str, torch.Tensor], points: torch.Tensor, seq_len: int,
                  num_classes: int, class_aware: bool):
    """(m_scores, m_start_end, m_labels, gt_cls, gt_reg) from the padded
    events of `batch`, on its device."""
    m_scores, m_start_end, m_labels = frame_targets_batch(
        batch["gt_segments"], batch["gt_labels"], batch["gt_valid"], seq_len, num_classes)
    gt_cls, gt_reg = assign_labels_batch(points, batch["gt_segments"], batch["gt_labels"],
                                         batch["gt_valid"], num_classes, class_aware)
    return m_scores, m_start_end, m_labels, gt_cls, gt_reg


def loss_kwargs(cfg: Dict) -> Dict:
    mcfg = cfg["model"]
    return dict(
        class_aware=mcfg["class_aware"],
        loss_weight=cfg["train_cfg"]["loss_weight"],
        inter_weight=mcfg["inter_contr_weight"],
        intra_weight=mcfg["intra_contr_weight"],
        score_v_weight=mcfg["score_V_weight"],
        score_a_weight=mcfg["score_A_weight"],
        label_smoothing=cfg["train_cfg"]["label_smoothing"],
    )


def make_train_step(model, optimizer, cfg: Dict, device=None, mesh=None) -> Callable:
    """train_step(state, batch, seed=0) -> losses, for a state made by
    create_train_state(model, optimizer, ...). `batch` holds visual
    (B, T, Dv), audio (B, T, Da), mask (B, T) and the events gt_segments
    (B, N, 2) in feature-grid units, gt_labels (B, N), gt_valid (B, N), as
    numpy arrays or tensors; pinned host tensors (the Batcher's on CUDA) are
    copied on a copy stream, overlapping the compute already queued. The
    state is updated in place; the returned losses are device scalars (no
    host sync). Runs on CUDA unless device='cpu'. A model that computes in
    bf16 (tpu.compute_dtype) trains through the bf16 backward kernels; its
    parameters, optimizer state, EMA and losses stay fp32, as in JAX.

    With a data-parallel `mesh` (on its device) `batch` is the rank's row
    block, and the returned losses are the global batch's, on every rank;
    every rank's state stays the same."""
    device = mesh.device if mesh is not None else resolve_device(device)
    model.to(device).train()
    mcfg = cfg["model"]
    seq_len, num_classes = mcfg["max_seq_len"], mcfg["num_classes"]
    class_aware = mcfg["class_aware"]
    points = torch.from_numpy(concat_points(generate_points(
        seq_len, mcfg["regression_range"], mcfg["scale_factor"]))).to(device)
    kw = loss_kwargs(cfg)
    copy = make_batch_copier(device)
    grad_sum = GradSum(optimizer.params, mesh) if sharded(mesh) else (lambda: None)

    def train_step(state: TrainState, batch: Dict, seed: int = 0) -> Dict[str, torch.Tensor]:
        with span("unav.train.step"):
            if not model.training:          # a validation of the raw weights set eval()
                model.train()
            with span("unav.train.forward"):
                b = copy(batch, BATCH_KEYS)
                b["mask"], b["gt_valid"] = b["mask"].bool(), b["gt_valid"].bool()
                m_scores, m_start_end, m_labels, gt_cls, gt_reg = build_targets(
                    b, points, seq_len, num_classes, class_aware)
                inputs = {"visual": b["visual"].float(), "audio": b["audio"].float(),
                          "mask": b["mask"], "m_scores": m_scores, "m_start_end": m_start_end,
                          "m_labels": m_labels}
                gen = torch.Generator(device=device).manual_seed(fold_in(seed, state.step))
                out = model(inputs, with_losses=True, generator=gen, mesh=mesh)
                losses, new_norm = compute_losses(out, gt_cls, gt_reg, state.loss_normalizer,
                                                  mesh=mesh, **kw)
            with span("unav.train.backward"):
                optimizer.zero_grad()
                losses["final_loss"].backward()
            with span("unav.train.update"):
                grad_sum()
                optimizer.step()
                ema_update(state.ema, model)
                state.loss_normalizer = new_norm.detach()
            state.step += 1
            return sum_losses(losses, mesh)

    return train_step
