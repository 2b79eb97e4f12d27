"""The serving entry point: a batch of pre-extracted features in,
(t_start, t_end, class, score) detections out."""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from ..core.device import resolve_device
from ..geometry.points import generate_points
from .decode import decode_batch, postprocess_batch

BATCH_KEYS = ("visual", "audio", "mask", "fps", "duration", "feat_stride",
              "feat_num_frames")


def make_eval_step(model, cfg: Dict, device=None) -> Callable:
    """eval_step(batch) -> detections, the reference inference protocol
    (no losses). `batch` holds visual (B, T, Dv), audio (B, T, Da), mask
    (B, T) and per-video fps, duration, feat_stride, feat_num_frames (B,),
    as numpy arrays or tensors. Detections: segments (B, M, 2) in seconds,
    scores (B, M), labels (B, M), valid (B, M), with M = max_seg_num, on
    the device. Runs on CUDA unless device='cpu'. tpu.nms_max_candidates
    caps the candidates before NMS as the JAX eval step does;
    tpu.approx_topk is refused.

    A batch of pinned host tensors (data/pipeline.py on CUDA) is copied
    with non_blocking=True on a copy stream of the step's own, so the copy
    overlaps the compute already queued; the compute stream waits on an
    event recorded after the copy. Any other batch takes the pageable copy
    on the compute stream."""
    device = resolve_device(device)
    mcfg, test_cfg, tpu = cfg["model"], cfg["test_cfg"], cfg.get("tpu", {})
    if tpu.get("approx_topk", False):
        raise NotImplementedError("tpu.approx_topk: lax.approx_max_k is a TPU approximation "
                                  "of the top-k that the port does not take; it runs the "
                                  "exact top-k with approx_topk False")
    max_candidates = int(tpu.get("nms_max_candidates", 0))
    model = model.to(device).eval()
    class_aware = mcfg["class_aware"]
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    points_by_len: Dict[int, List[torch.Tensor]] = {}

    def to_device(batch: Dict) -> Dict[str, torch.Tensor]:
        vals = {k: batch[k] for k in BATCH_KEYS}
        if copy_stream is None or not all(isinstance(v, torch.Tensor) and v.is_pinned()
                                          for v in vals.values()):
            return {k: torch.as_tensor(v).to(device) for k, v in vals.items()}
        compute = torch.cuda.current_stream(device)
        with torch.cuda.stream(copy_stream):
            # the host allocator records the copy on copy_stream: a pinned
            # block is not handed out again before the copy has read it
            b = {k: v.to(device, non_blocking=True) for k, v in vals.items()}
            copied = torch.cuda.Event()
            copied.record(copy_stream)
        compute.wait_event(copied)
        for v in b.values():        # allocated on copy_stream, used on compute
            v.record_stream(compute)
        return b

    def points_for(seq_len: int) -> List[torch.Tensor]:
        if seq_len not in points_by_len:
            points_by_len[seq_len] = [torch.from_numpy(p).to(device) for p in generate_points(
                seq_len, mcfg["regression_range"], mcfg["scale_factor"])]
        return points_by_len[seq_len]

    def eval_step(batch: Dict) -> Dict[str, torch.Tensor]:
        b = to_device(batch)
        b["mask"] = b["mask"].bool()
        points = points_for(int(b["visual"].shape[1]))
        with torch.inference_mode():
            out = model(b, with_losses=False)
            cands = decode_batch(
                out["cls_logits"], out["offsets"], out["masks"], points,
                pre_nms_thresh=test_cfg["pre_nms_thresh"],
                pre_nms_topk=test_cfg["pre_nms_topk"],
                duration_thresh=test_cfg["duration_thresh"],
                class_aware=class_aware,
                max_candidates=max_candidates,
            )
            segs, scores, labels, valid = postprocess_batch(
                *cands, num_classes=mcfg["num_classes"], test_cfg=test_cfg,
                fps=b["fps"].float(),
                duration=b["duration"].float(),
                feat_stride=b["feat_stride"].float(),
                num_frames=b["feat_num_frames"].float(),
            )
        return {"segments": segs, "scores": scores, "labels": labels, "valid": valid}

    eval_step.model = model
    return eval_step


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
