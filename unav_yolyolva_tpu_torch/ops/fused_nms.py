"""Merged class-masked Soft-NMS: hand-written CUDA kernel and its plain
version.

Replaces the Pallas kernel `_kernel_classmasked` /
`multiclass_soft_nms_pallas` (unav_yolyolva_tpu/ops/pallas_nms.py:109-247).
Per-class Soft-NMS over disjoint class subsets is one select-and-decay scan
over the union with cross-class weight 1, whose emissions come out already
in descending-score order. Each step: argmax (lowest index on ties), emit
it with its current score, decay same-class lanes by the Gaussian weight
exp(-iou^2 / sigma) (IoU with the x2 - x1 + 1e-6 area epsilon), kill
same-class lanes below min_score and the emitted lane; a row with nothing
alive emits -1 / 0. The eval protocol's method (Gaussian) is the only one
ported: the hard and linear weights wait with batched_nms.

On the card (csrc/nms.cu) it is bound by latency: max_out dependent steps,
each a block-wide argmax. The design keeps a row's scores and classes in the
registers of one 1024-thread block, so a step costs two barriers and no
device-memory round trip; the ~10 MB of candidates are read once.
"""

from __future__ import annotations

import torch

from . import cuda_build
from .cuda_build import FLOAT, INT, PTR

MAX_CANDIDATES = 16384  # 1024 threads x 16 register slots

_ARGTYPES = {
    "unav_multiclass_soft_nms": [PTR, PTR, PTR, INT, INT, INT, FLOAT, FLOAT,
                                 PTR, PTR, PTR],
}


def multiclass_soft_nms_reference(segs, scores, cls_idxs, *, max_out: int,
                                  sigma: float, min_score: float):
    """Plain PyTorch version of the merged scan over G rows."""
    g, n = scores.shape
    neg_inf = float("-inf")
    s = scores.float().clone()
    x1, x2 = segs[..., 0], segs[..., 1]
    cls = cls_idxs.long()
    lane = torch.arange(n, device=s.device)[None, :]
    out_idx = torch.full((g, max_out), -1, dtype=torch.int32, device=s.device)
    out_score = torch.zeros((g, max_out), dtype=torch.float32, device=s.device)
    for k in range(max_out):
        j = s.argmax(dim=1, keepdim=True)                       # first max
        smax = s.gather(1, j)
        alive = smax > neg_inf                                   # (G, 1)
        if not bool(alive.any()):
            break
        out_idx[:, k] = torch.where(alive, j, -1)[:, 0].int()
        out_score[:, k] = torch.where(alive, smax, 0.0)[:, 0]
        sx1, sx2, scls = x1.gather(1, j), x2.gather(1, j), cls.gather(1, j)
        inter = (torch.minimum(sx2, x2) - torch.maximum(sx1, x1)).clamp(min=0.0)
        iou = inter / ((sx2 - sx1 + 1e-6) + (x2 - x1 + 1e-6) - inter)
        same = cls == scls
        s_new = torch.where(same, s * torch.exp(-(iou * iou) / sigma), s)
        kill = (same & (s_new < min_score)) | (lane == j) | (s == neg_inf)
        s_new = s_new.masked_fill(kill, neg_inf)
        s = torch.where(alive, s_new, s)
    return out_idx, out_score, out_idx >= 0


def multiclass_soft_nms(segs, scores, cls_idxs, *, max_out: int, sigma: float,
                        min_score: float):
    """Merged Soft-NMS of G independent candidate sets: segs (G, N, 2),
    scores (G, N) with -inf for invalid candidates, cls_idxs (G, N).
    Returns (idx (G, max_out) int32 with -1 for empty slots, score
    (G, max_out), valid (G, max_out)), in descending-score order.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    kw = dict(max_out=max_out, sigma=sigma, min_score=min_score)
    if segs.device.type == "cpu":
        return multiclass_soft_nms_reference(segs, scores, cls_idxs, **kw)
    g, n = scores.shape
    if n > MAX_CANDIDATES:
        raise ValueError(f"multiclass_soft_nms: {n} candidates per row, "
                         f"the kernel holds at most {MAX_CANDIDATES}")
    segs = segs.float().contiguous()
    scores = scores.float().contiguous()
    cls = cls_idxs.int().contiguous()
    if segs.device.type != "cuda" or tuple(segs.shape) != (g, n, 2) \
            or cls.shape != scores.shape:
        raise ValueError("multiclass_soft_nms: expected CUDA (G, N, 2), (G, N), (G, N)")
    out_idx = torch.empty((g, max_out), dtype=torch.int32, device=segs.device)
    out_score = torch.empty((g, max_out), dtype=torch.float32, device=segs.device)
    if g and max_out:
        lib = cuda_build.library("nms", _ARGTYPES)
        rc = lib.unav_multiclass_soft_nms(
            segs.data_ptr(), scores.data_ptr(), cls.data_ptr(), g, n, max_out,
            sigma, min_score, out_idx.data_ptr(),
            out_score.data_ptr(), torch.cuda.current_stream(segs.device).cuda_stream,
        )
        cuda_build.check(lib, rc, "multiclass_soft_nms")
        multiclass_soft_nms.launches += 1
    return out_idx, out_score, out_idx >= 0


multiclass_soft_nms.launches = 0
