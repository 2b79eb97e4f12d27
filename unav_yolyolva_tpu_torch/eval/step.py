"""The serving entry point: a batch of pre-extracted features in,
(t_start, t_end, class, score) detections out."""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from ..core.device import make_batch_copier, resolve_device
from ..geometry.points import generate_points
from ..models.meta_arch import compute_losses
from ..parallel.collectives import gather_rows, sharded, sum_losses
from ..train.step import build_targets, loss_kwargs
from ..utils.profiling import span, spanned
from .decode import decode_batch, postprocess_batch

BATCH_KEYS = ("visual", "audio", "mask", "fps", "duration", "feat_stride",
              "feat_num_frames")
GT_KEYS = ("gt_segments", "gt_labels", "gt_valid")


def make_eval_step(model_or_state, cfg: Dict, device=None, *, with_losses: bool = False,
                   use_ema: bool = True, mesh=None) -> Callable:
    """eval_step(batch) -> detections, the reference inference protocol; with
    with_losses=True, eval_step(batch) -> (detections, losses), the
    validation of a train state.

    `model_or_state` is the model to serve, or a TrainState: its EMA
    (use_ema, the default) or its raw weights are served, and the losses
    use its loss normalizer as it stands at each call (the JAX eval step's
    `use_ema` and `state.loss_normalizer`). Losses need a TrainState.

    `batch` holds visual (B, T, Dv), audio (B, T, Da), mask (B, T) and
    per-video fps, duration, feat_stride, feat_num_frames (B,), and for the
    losses the padded events gt_segments, gt_labels, gt_valid, as numpy
    arrays or tensors. Detections: segments (B, M, 2) in seconds, scores
    (B, M), labels (B, M), valid (B, M), with M = max_seg_num; losses: the
    train step's device scalars, from dense targets built on the device as
    the train step builds them. All on the device: no host sync. Runs on
    CUDA unless device='cpu'. tpu.nms_max_candidates caps the candidates
    before NMS as the JAX eval step does. tpu.approx_topk takes the exact
    top-k: the JAX step's lax.approx_max_k approximates only on a TPU, and
    computes the exact top-k on every other backend.

    A batch of pinned host tensors (data/pipeline.py on CUDA) is copied on a
    copy stream of the step's own (core/device.py:make_batch_copier).

    Spans (utils/profiling.py): `unav.eval.step` around the call, and in it
    `unav.eval.forward` (the copy and the model) and `unav.eval.postprocess`
    (decode, Soft-NMS and the detections in seconds); `fetch_detections` is
    `unav.eval.fetch`.

    With a data-parallel `mesh` (on its device) `batch` is the rank's row
    block of the global batch (train/loop.py:valid_one_epoch pads the last
    one): each rank serves its rows, and the detections of every rank are
    gathered (one collective a batch), so that every rank holds all rows of
    the global batch in rank order; the losses are the global batch's (one
    more)."""
    device = mesh.device if mesh is not None else resolve_device(device)
    mcfg, test_cfg, tpu = cfg["model"], cfg["test_cfg"], cfg.get("tpu", {})
    state = model_or_state if hasattr(model_or_state, "loss_normalizer") else None
    if with_losses and state is None:
        raise ValueError("make_eval_step: the losses need a TrainState (its loss normalizer)")
    model = model_or_state if state is None else (state.ema if use_ema else state.model)
    max_candidates = int(tpu.get("nms_max_candidates", 0))
    model = model.to(device).eval()
    class_aware, num_classes = mcfg["class_aware"], mcfg["num_classes"]
    kw = loss_kwargs(cfg) if with_losses else None
    copy = make_batch_copier(device)
    keys = BATCH_KEYS + (GT_KEYS if with_losses else ())
    points_by_len: Dict[int, List[torch.Tensor]] = {}

    def points_for(seq_len: int) -> List[torch.Tensor]:
        if seq_len not in points_by_len:
            points_by_len[seq_len] = [torch.from_numpy(p).to(device) for p in generate_points(
                seq_len, mcfg["regression_range"], mcfg["scale_factor"])]
        return points_by_len[seq_len]

    def eval_step(batch: Dict):
        with span("unav.eval.step"):
            with span("unav.eval.forward"):
                b = copy(batch, keys)
                b["mask"] = b["mask"].bool()
                seq_len = int(b["visual"].shape[1])
                points = points_for(seq_len)
                with torch.inference_mode():
                    if with_losses:
                        b["gt_valid"] = b["gt_valid"].bool()
                        b["m_scores"], b["m_start_end"], b["m_labels"], gt_cls, gt_reg = \
                            build_targets(b, torch.cat(points), seq_len, num_classes,
                                          class_aware)
                    out = model(b, with_losses=with_losses, mesh=mesh)
            with torch.inference_mode():
                with span("unav.eval.postprocess"):
                    cands = decode_batch(
                        out["cls_logits"], out["offsets"], out["masks"], points,
                        pre_nms_thresh=test_cfg["pre_nms_thresh"],
                        pre_nms_topk=test_cfg["pre_nms_topk"],
                        duration_thresh=test_cfg["duration_thresh"],
                        class_aware=class_aware,
                        max_candidates=max_candidates,
                    )
                    segs, scores, labels, valid = postprocess_batch(
                        *cands, num_classes=num_classes, test_cfg=test_cfg,
                        fps=b["fps"].float(),
                        duration=b["duration"].float(),
                        feat_stride=b["feat_stride"].float(),
                        num_frames=b["feat_num_frames"].float(),
                    )
                dets = {"segments": segs, "scores": scores, "labels": labels, "valid": valid}
                dets = _gather_detections(dets, mesh)
                if not with_losses:
                    return dets
                losses, _ = compute_losses(out, gt_cls, gt_reg, state.loss_normalizer,
                                           mesh=mesh, **kw)
                return dets, sum_losses(losses, mesh)

    eval_step.model = model
    eval_step.with_losses = with_losses
    eval_step.mesh = mesh
    return eval_step


def _gather_detections(dets: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """Every rank's detections in rank order, in one gather: the four
    fixed-shape tensors travel as one fp32 buffer, which carries each
    exactly (fp32 and bf16 values, class indices, 0/1 validity)."""
    if not sharded(mesh):
        return dets
    b = dets["valid"].shape[0]
    flat = gather_rows(torch.cat([v.reshape(b, -1).float() for v in dets.values()], 1), mesh)
    out, at = {}, 0
    for k, v in dets.items():
        n = v[0].numel()
        out[k] = flat[:, at:at + n].reshape((-1,) + tuple(v.shape[1:])).to(v.dtype)
        at += n
    return out


@spanned("unav.eval.fetch")
def fetch_detections(dets: Dict[str, torch.Tensor]):
    """Start the copy of a step's detections to the host: on CUDA into pinned
    tensors with non_blocking=True, an event recorded after it; returns
    (host tensors, the event or None). Wait on the event before reading."""
    if dets["valid"].device.type != "cuda":
        return dets, None
    host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True) for k, v in dets.items()}
    for k, v in dets.items():
        host[k].copy_(v, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done
