"""Soft-NMS scans: hand-written CUDA kernels and their plain versions.

`multiclass_soft_nms` replaces the Pallas kernel `_kernel_classmasked` /
`multiclass_soft_nms_pallas` (unav_yolyolva_tpu/ops/pallas_nms.py:109-247).
Per-class Soft-NMS over disjoint class subsets is one select-and-decay scan
over the union with cross-class weight 1, whose emissions come out already
in descending-score order. Each step: argmax (lowest index on ties), emit
it with its current score, decay same-class lanes by the Gaussian weight
exp(-iou^2 / sigma) (IoU with the x2 - x1 + 1e-6 area epsilon), kill
same-class lanes below min_score and the emitted lane; a row with nothing
alive emits -1 / 0.

`soft_nms` replaces the Pallas kernel `_kernel` / `soft_nms_pallas`
(pallas_nms.py:43-106, :255-309): the same scan with every lane in one
class, and the weight by method (0 hard: iou < thr; 1 linear: 1 - iou from
thr on; 2 Gaussian). The min_score kill applies to every live lane. It
serves the hard and single-class configurations through ops/nms.py.

On the card (csrc/nms.cu) both are bound by max_out dependent steps times
the latency of one step; the candidates are read once, at setup. So each
scan makes a step cost what changes at it, not N, and a lane that does not
overlap the winner skips the two divisions (its IoU is exactly 0, its
weight taken once). The merged scan buckets a row's live lanes by class
(cls mod 128) in shared memory and keeps a head (best lane) per bucket in
the registers of a 128-thread group: a step is the group's argmax over the
heads, one pass over the winner's bucket and one named barrier, unless that
bucket is large (one class holding much of the row), when the whole block
takes the step. The single-class scan compacts each row's live lanes first
and walks only those; its one pass a step decays and finds the next argmax
together. A warp takes a row of at most 1024 candidates, a block a longer
row.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .cuda_build import FLOAT, INT, PTR
from ..utils.profiling import spanned

MAX_CANDIDATES = 16384  # 14-bit lane indices; 14 bytes a lane of shared memory
NMS_HARD, NMS_LINEAR, NMS_GAUSSIAN = 0, 1, 2

_ARGTYPES = {
    "unav_multiclass_soft_nms": [PTR, PTR, PTR, INT, INT, INT, FLOAT, FLOAT,
                                 PTR, PTR, PTR],
    "unav_soft_nms": [PTR, PTR, INT, INT, INT, INT, FLOAT, FLOAT, FLOAT, PTR, PTR, PTR],
    "unav_nms_launch_info": [INT, INT, PTR],
}
LAUNCH_INFO = ("blocks_per_sm", "threads", "rows_per_block", "slots", "smem_bytes",
               "registers", "local_bytes")


def _scan_reference(segs, scores, cls_idxs, *, max_out: int, iou_threshold: float,
                    sigma: float, min_score: float, method: int):
    """The select-and-decay scan over G rows in plain PyTorch, line for line
    the Pallas `_kernel_classmasked` (cls_idxs given: other classes keep
    weight 1 and are not killed) or `_kernel` (cls_idxs None)."""
    g, n = scores.shape
    neg_inf = float("-inf")
    s = scores.float().clone()
    x1, x2 = segs[..., 0].float(), segs[..., 1].float()
    cls = None if cls_idxs is None else cls_idxs.long()
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
        sx1, sx2 = x1.gather(1, j), x2.gather(1, j)
        inter = (torch.minimum(sx2, x2) - torch.maximum(sx1, x1)).clamp(min=0.0)
        iou = inter / ((sx2 - sx1 + 1e-6) + (x2 - x1 + 1e-6) - inter)
        if method == NMS_HARD:
            w = (iou < iou_threshold).float()
        elif method == NMS_LINEAR:
            w = torch.where(iou >= iou_threshold, 1.0 - iou, 1.0)
        else:
            w = torch.exp(-(iou * iou) / sigma)
        low = s * w < min_score
        if cls is not None:
            same = cls == cls.gather(1, j)
            w, low = torch.where(same, w, 1.0), same & low
        kill = low | (lane == j) | (s == neg_inf)
        s = torch.where(alive, (s * w).masked_fill(kill, neg_inf), s)
    return out_idx, out_score, out_idx >= 0


def multiclass_soft_nms_reference(segs, scores, cls_idxs, *, max_out: int,
                                  sigma: float, min_score: float):
    """Plain PyTorch version of the merged scan over G rows."""
    return _scan_reference(segs, scores, cls_idxs, max_out=max_out, iou_threshold=0.0,
                           sigma=sigma, min_score=min_score, method=NMS_GAUSSIAN)


@spanned("unav.kernel.nms")
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


def soft_nms_reference(segs, scores, *, max_out: int, iou_threshold: float, sigma: float,
                       min_score: float, method: int = NMS_GAUSSIAN):
    """Plain PyTorch version of the single-class scan over G rows."""
    return _scan_reference(segs, scores, None, max_out=max_out, iou_threshold=iou_threshold,
                           sigma=sigma, min_score=min_score, method=method)


@spanned("unav.kernel.nms")
def soft_nms(segs, scores, *, max_out: int, iou_threshold: float, sigma: float,
             min_score: float, method: int = NMS_GAUSSIAN):
    """Single-class Soft-NMS of G independent candidate rows: segs (G, N, 2),
    scores (G, N) with -inf for invalid candidates. Returns (idx (G,
    max_out) int32 with -1 for empty slots, score (G, max_out), valid (G,
    max_out)), in emission order. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    kw = dict(max_out=max_out, iou_threshold=iou_threshold, sigma=sigma,
              min_score=min_score, method=method)
    if segs.device.type == "cpu":
        return soft_nms_reference(segs, scores, **kw)
    g, n = scores.shape
    if n > MAX_CANDIDATES or method not in (NMS_HARD, NMS_LINEAR, NMS_GAUSSIAN):
        raise ValueError(f"soft_nms: {n} candidates per row (at most {MAX_CANDIDATES}), "
                         f"method {method}")
    segs = segs.float().contiguous()
    scores = scores.float().contiguous()
    if scores.device.type != "cuda" or tuple(segs.shape) != (g, n, 2):
        raise ValueError("soft_nms: expected CUDA (G, N, 2) segments and (G, N) scores")
    out_idx = torch.empty((g, max_out), dtype=torch.int32, device=segs.device)
    out_score = torch.empty((g, max_out), dtype=torch.float32, device=segs.device)
    if g and max_out:
        lib = cuda_build.library("nms", _ARGTYPES)
        rc = lib.unav_soft_nms(
            segs.data_ptr(), scores.data_ptr(), g, n, max_out, method, iou_threshold, sigma,
            min_score, out_idx.data_ptr(), out_score.data_ptr(),
            torch.cuda.current_stream(segs.device).cuda_stream,
        )
        cuda_build.check(lib, rc, "soft_nms")
        soft_nms.launches += 1
    return out_idx, out_score, out_idx >= 0


soft_nms.launches = 0


def launch_info(n: int, *, merged: bool) -> dict:
    """What a launch on rows of n candidates runs on the current card:
    resident blocks per SM, threads and rows per block, register slots per
    thread (0 for the merged scan), dynamic shared bytes, registers and
    local (spill) bytes per thread."""
    lib = cuda_build.library("nms", _ARGTYPES)
    info = (ctypes.c_int * len(LAUNCH_INFO))()
    cuda_build.check(lib, lib.unav_nms_launch_info(int(merged), n, ctypes.addressof(info)),
                     "nms launch info")
    return dict(zip(LAUNCH_INFO, info))
