"""The serving entry point: a batch of pre-extracted features in,
(t_start, t_end, class, score) detections out."""

from __future__ import annotations

from typing import Callable, Dict

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
    tpu.approx_topk is refused."""
    device = resolve_device(device)
    mcfg, test_cfg, tpu = cfg["model"], cfg["test_cfg"], cfg.get("tpu", {})
    if tpu.get("approx_topk", False):
        raise NotImplementedError("tpu.approx_topk: lax.approx_max_k is a TPU approximation "
                                  "of the top-k that the port does not take; it runs the "
                                  "exact top-k with approx_topk False")
    max_candidates = int(tpu.get("nms_max_candidates", 0))
    model = model.to(device).eval()
    class_aware = mcfg["class_aware"]

    def eval_step(batch: Dict) -> Dict[str, torch.Tensor]:
        b = {k: torch.as_tensor(batch[k]).to(device) for k in BATCH_KEYS}
        b["mask"] = b["mask"].bool()
        seq_len = int(b["visual"].shape[1])
        points = [torch.from_numpy(p).to(device) for p in generate_points(
            seq_len, mcfg["regression_range"], mcfg["scale_factor"])]
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

    return eval_step
