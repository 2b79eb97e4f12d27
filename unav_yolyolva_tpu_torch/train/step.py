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
and the loss-normalizer EMA. On CUDA the copied batch's way to the grads
is replayed as one CUDA graph (make_train_step). Spans
(utils/profiling.py): `unav.train.step` around the call, and in it, on an
eager step, `unav.train.forward` (the copy to the losses) and
`unav.train.backward` (the grads dropped, the backward); on a replayed
step `unav.train.replay` (the copy, the copy into the graph's inputs, the
replay), after `unav.train.capture` (the copy and, inside it, the
captured `.forward` and `.backward`) on the step that captures the graph;
then `unav.train.update` (the all-reduce, zero grads for the parameters
the backward left without one, clip and AdamW, the EMAs, the normalizer).

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

from collections import deque
from typing import Callable, Deque, Dict, Tuple

import torch

from ..core.device import make_batch_copier, resolve_device
from ..geometry.assign import assign_labels_batch, frame_targets_batch
from ..geometry.points import concat_points, generate_points
from ..models.blocks import tblock_mode
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


def _key(batch: Dict) -> Tuple:
    """What a captured step depends on beyond its inputs' values: every
    input's shape and dtype, the whole-block stem switch and cuDNN's
    determinism flag."""
    return (tuple((tuple(batch[k].shape), str(batch[k].dtype).replace("torch.", ""))
                  for k in BATCH_KEYS),
            tblock_mode(), torch.backends.cudnn.deterministic)


class _Captured:
    """The CUDA graph of one train step from the copied batch to the grads:
    its static inputs (the batch's arrays and the loss normalizer it reads),
    its outputs (the losses, the new normalizer, each parameter's grad or
    None where the backward gives none) and the key it was captured for."""

    def __init__(self, key, graph, inputs, norm, losses, new_norm, params, grads):
        self.key, self.graph, self.inputs, self.norm = key, graph, inputs, norm
        self.losses, self.new_norm, self.grads = losses, new_norm, grads
        self.no_grad = [p for p, g in zip(params, grads) if g is None]
        self.rebind = False     # an eager step has put other grads on the parameters


def make_train_step(model, optimizer, cfg: Dict, device=None, mesh=None) -> Callable:
    """train_step(state, batch, seed=0) -> losses, for a state made by
    create_train_state(model, optimizer, ...). `batch` holds visual
    (B, T, Dv), audio (B, T, Da), mask (B, T) and the events gt_segments
    (B, N, 2) in feature-grid units, gt_labels (B, N), gt_valid (B, N), as
    numpy arrays or tensors; pinned host tensors (the Batcher's on CUDA) are
    copied on a copy stream, overlapping the compute already queued. The
    state is updated in place; the returned losses are device scalars (no
    host sync), each step's its own. Runs on CUDA unless device='cpu'. A
    model that computes in bf16 (tpu.compute_dtype) trains through the bf16
    backward kernels; its parameters, optimizer state, EMA and losses stay
    fp32, as in JAX.

    On CUDA without a data-parallel group the step from the copied batch to
    the grads is one CUDA graph: the first step of a key (the batch's shapes
    and dtypes, the stem switch, cuDNN's determinism) runs eagerly, which
    loads the kernel libraries and the library handles; the next step of
    that key captures the graph and replays it, and every later step of the
    key copies its batch into the graph's inputs and replays it. The update
    stays eager, queued behind the replay. A step of another key runs
    eagerly; the graph is captured once. The replay computes the eager
    step's bits: the stochastic depth is drawn from one generator, seeded
    (seed, step) before every step and registered with the graph. The grads
    stay on the parameters between replays, which overwrite them. The host
    waits for step n - 2 before it queues step n, so that at most two steps
    are in flight. The counters `captures`, `replays` and `eager_steps` are
    attributes of the returned function (the capturing step is a replay
    too).

    With a data-parallel `mesh` (on its device) `batch` is the rank's row
    block, and the returned losses are the global batch's, on every rank;
    every rank's state stays the same. That path stays eager (GradSum
    reassigns the grads)."""
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
    gen = torch.Generator(device=device)
    graphed = device.type == "cuda" and not sharded(mesh)
    in_flight: Deque[torch.cuda.Event] = deque()
    warm_key, captured = None, None

    def losses_of(b: Dict[str, torch.Tensor], normalizer: torch.Tensor):
        """The forward in training mode from the copied batch to the losses
        and the new normalizer."""
        tb = dict(b, mask=b["mask"].bool(), gt_valid=b["gt_valid"].bool())
        m_scores, m_start_end, m_labels, gt_cls, gt_reg = build_targets(
            tb, points, seq_len, num_classes, class_aware)
        inputs = {"visual": tb["visual"].float(), "audio": tb["audio"].float(),
                  "mask": tb["mask"], "m_scores": m_scores, "m_start_end": m_start_end,
                  "m_labels": m_labels}
        out = model(inputs, with_losses=True, generator=gen, mesh=mesh)
        return compute_losses(out, gt_cls, gt_reg, normalizer, mesh=mesh, **kw)

    def eager(state: TrainState, batch: Dict):
        with span("unav.train.forward"):
            losses, new_norm = losses_of(copy(batch, BATCH_KEYS), state.loss_normalizer)
        with span("unav.train.backward"):
            optimizer.zero_grad()
            losses["final_loss"].backward()
        if captured is not None:
            captured.rebind = True
        train_step.eager_steps += 1
        return losses, new_norm

    def capture(state: TrainState, b: Dict[str, torch.Tensor], key) -> _Captured:
        """The graph of the forward and backward on static copies of `b`
        and of the normalizer. Nothing runs until it is replayed. Captured
        in thread-local mode: the Batcher's copier thread may pin host
        memory meanwhile."""
        inputs = {k: v.clone() for k, v in b.items()}
        norm = state.loss_normalizer.detach().to(device=device, dtype=torch.float32,
                                                  copy=True)
        optimizer.zero_grad()                   # the captured backward assigns the grads
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(gen)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            with span("unav.train.forward"):
                losses, new_norm = losses_of(inputs, norm)
            with span("unav.train.backward"):
                losses["final_loss"].backward()
        train_step.captures += 1
        return _Captured(key, graph, inputs, norm, {k: v.detach() for k, v in losses.items()},
                         new_norm.detach(), optimizer.params,
                         [p.grad for p in optimizer.params])

    def replay(state: TrainState, cap: _Captured, b: Dict[str, torch.Tensor]):
        """The graph's step on batch `b`: its losses, copied out of the
        graph's outputs; the state's normalizer becomes the graph's input."""
        for k, v in b.items():
            cap.inputs[k].copy_(v)
        if state.loss_normalizer is not cap.norm:
            cap.norm.copy_(state.loss_normalizer)
            state.loss_normalizer = cap.norm
        cap.graph.replay()
        if cap.rebind:
            for p, g in zip(optimizer.params, cap.grads):
                p.grad = g
            cap.rebind = False
        for p in cap.no_grad:               # the update gives it a zero grad, as eagerly
            p.grad = None
        train_step.replays += 1
        return {k: v.clone() for k, v in cap.losses.items()}

    def train_step(state: TrainState, batch: Dict, seed: int = 0) -> Dict[str, torch.Tensor]:
        nonlocal warm_key, captured
        with span("unav.train.step"):
            if not model.training:          # a validation of the raw weights set eval()
                model.train()
            if len(in_flight) == 2:         # step n - 2 done before step n is queued
                in_flight.popleft().synchronize()
            gen.manual_seed(fold_in(seed, state.step))
            key = _key(batch) if graphed else None
            cap = captured
            if key is not None and cap is None and key == warm_key:
                with span("unav.train.capture"):
                    b = copy(batch, BATCH_KEYS)
                    cap = captured = capture(state, b, key)
                with span("unav.train.replay"):
                    losses = replay(state, cap, b)
            elif key is not None and cap is not None and key == cap.key:
                with span("unav.train.replay"):
                    losses = replay(state, cap, copy(batch, BATCH_KEYS))
            else:
                warm_key, cap = key, None
                losses, new_norm = eager(state, batch)
            with span("unav.train.update"):
                grad_sum()
                optimizer.step()
                ema_update(state.ema, model)
                if cap is None:
                    state.loss_normalizer = new_norm.detach()
                else:
                    cap.norm.copy_(cap.new_norm)
            if device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
                in_flight.append(done)
            state.step += 1
            return sum_losses(losses, mesh)

    train_step.captures = train_step.replays = train_step.eager_steps = 0
    return train_step
