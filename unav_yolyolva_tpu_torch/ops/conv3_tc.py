"""The event-dependency block's two k=3 convolutions on the tensor cores:
a hand-written CUDA kernel (`csrc/conv3_tc.cu`) and its plain version.

    y[b, t, n] = epi(sum_{tap, c} x[b, t + tap - 1, c] W[n, c, tap]) * mask[b, t]

over (B, T, Kc) fp32 activations as they lie (zero outside the sequence),
W the conv's weight as `nn.Conv1d` keeps it, (N, Kc, 3), epi the ReLU or
nothing: `MaskedConv1D`'s contract at stride 1 without bias, and the
block's ReLU after its expanding conv. It replaces, on the fp32 CUDA path of
`models/dependency.py`, the block's `MaskedConv1D` -> cuDNN calls (fp32 at
the FFMA rate, with transposes, the ReLU and the mask multiply as passes of
their own); no Pallas kernel: the JAX package's block runs XLA's conv.

The product is 3xTF32 (`ops/gemm_tc.py`'s scheme): each operand split as
hi = tf32(x), lo = tf32(x - hi), lo.hi + hi.lo + hi.hi summed in fp32, each
32-deep slice of k (32 channels of one tap) summed from zero and then added
to the total, the slices in the order (channel block, tap). The kernel runs
it on `wgmma` fed by TMA: the weight split once a call into (N, 3, Kc)
halves (`conv3_split`, one pass), the activation split in registers. One
launch takes the tiles of up to six levels that share the weight; every
output is summed by one thread in the same order whatever the levels of the
launch, so the bits do not depend on them. The plain version
(`masked_conv3_reference`) repeats that arithmetic, slice order included,
with fp32 sums rounded to nearest where the tensor cores truncate: it
matches the kernel's error budget, not its bits.

`masked_conv3` is a `torch.autograd.Function` when a grad is needed: its
backward runs the port's 3xTF32 products (`tf32x3_products`): the input
grad as A.B with the transposed conv's loader (taps 3, tapdir -1), the
weight grad as A^T.B with the shifted-B loader (btaps 3), the ReLU's mask
taken from the saved output. CPU tensors take the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..utils.profiling import spanned
from . import cuda_build
from .cuda_build import INT, PTR
from .gemm_tc import SLICE, conv3_taps, tf32x3_matmul_reference, tf32x3_products, tf32x3_split

_ARGTYPES = {"unav_conv3_tc": [INT, PTR, PTR, PTR, PTR, INT, INT, INT, PTR],
             "unav_conv3_split": [PTR, PTR, PTR, INT, INT, PTR]}
MAX_LEVELS = 6      # levels of one launch (DC_MAX_LEVELS)


def _slice_order(a: torch.Tensor, kc: int) -> torch.Tensor:
    """The columns k = tap * kc + c of a (M, 3 * kc) in the kernel's order of
    slices: blocks of SLICE channels, each with its three taps (kc padded
    with zeros to whole blocks)."""
    m, kp = a.shape[0], -(-kc // SLICE) * SLICE
    a = F.pad(a.reshape(m, 3, kc), (0, kp - kc))
    return a.reshape(m, 3, kp // SLICE, SLICE).permute(0, 2, 1, 3).reshape(m, 3 * kp)


def masked_conv3_reference(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor,
                           relu: bool = False) -> torch.Tensor:
    """Plain version of one level of `masked_conv3`: x (B, T, Kc), w (N, Kc,
    3), mask (B, T) bool -> (B, T, N), as the kernel computes it."""
    b, t, kc = x.shape
    n = w.shape[0]
    a = _slice_order(conv3_taps(x.reshape(b * t, kc), t), kc)
    wk = _slice_order(w.permute(0, 2, 1).reshape(n, 3 * kc), kc)
    y = tf32x3_matmul_reference(a, wk.transpose(0, 1))
    if relu:
        y = y.clamp_min(0)
    return (y * mask.reshape(-1, 1).to(y.dtype)).reshape(b, t, n)


def conv3_split(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weight's halves that `masked_conv3` reads: w (N, Kc, 3) ->
    (hi, lo), each (N, 3, Kc), hi = tf32(w), lo = tf32(w - hi). Computed
    anew each call, never cached: the train step's CUDA graph replays the
    split after each update of w. CPU tensors take the plain version; CUDA
    tensors launch one pass (conv3_split_kernel)."""
    w = w.detach()
    if w.device.type == "cpu":
        return tf32x3_split(w.permute(0, 2, 1).contiguous())
    if w.dtype != torch.float32 or w.dim() != 3 or w.shape[2] != 3 or not w.is_contiguous():
        raise ValueError(f"conv3_split: needs a contiguous fp32 (N, Kc, 3) weight, got "
                         f"{w.dtype} {tuple(w.shape)}")
    n, kc, _ = w.shape
    hi = torch.empty((n, 3, kc), device=w.device, dtype=torch.float32)
    lo = torch.empty_like(hi)
    lib = cuda_build.library("conv3_tc", _ARGTYPES)
    rc = lib.unav_conv3_split(w.data_ptr(), hi.data_ptr(), lo.data_ptr(), n, kc,
                              torch.cuda.current_stream(w.device).cuda_stream)
    cuda_build.check(lib, rc, "conv3_split")
    return hi, lo


def _launch(xs, masks, hi, lo, relu: bool) -> List[torch.Tensor]:
    """One kernel launch over the levels; raises on what it does not take."""
    if not 1 <= len(xs) <= MAX_LEVELS or len(masks) != len(xs):
        raise ValueError(f"masked_conv3: 1 to {MAX_LEVELS} levels with a mask each, got "
                         f"{len(xs)} and {len(masks)}")
    dev = hi.device
    n, _, kc = hi.shape
    for name, h in (("hi", hi), ("lo", lo)):
        if (h.device.type != "cuda" or h.dtype != torch.float32 or h.dim() != 3
                or tuple(h.shape) != (n, 3, kc) or not h.is_contiguous() or h.data_ptr() % 16):
            raise ValueError(f"masked_conv3: the weight's {name} needs a contiguous, 16-byte "
                             f"aligned fp32 (N, 3, Kc) CUDA tensor, got {h.dtype} "
                             f"{tuple(h.shape)} on {h.device}")
    if kc % 4 or n % 2:
        raise ValueError(f"masked_conv3: Kc ({kc}) must be a multiple of 4 and N ({n}) even")
    ptrs, ints, ys = [], [], []
    for x, mask in zip(xs, masks):
        if (x.device != dev or x.dtype != torch.float32 or x.dim() != 3 or x.shape[2] != kc
                or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(f"masked_conv3: x needs a contiguous, 16-byte aligned fp32 "
                             f"(B, T, {kc}) tensor on {dev}, got {x.dtype} {tuple(x.shape)} "
                             f"on {x.device}")
        b, t, _ = x.shape
        if (mask.device != dev or mask.dtype != torch.bool or tuple(mask.shape) != (b, t)
                or not mask.is_contiguous()):
            raise ValueError(f"masked_conv3: mask needs a contiguous bool ({b}, {t}) tensor "
                             f"on {dev}, got {mask.dtype} {tuple(mask.shape)}")
        y = torch.empty((b, t, n), device=dev, dtype=torch.float32)
        ptrs += [x.data_ptr(), y.data_ptr(), mask.data_ptr()]
        ints += [b * t, t]
        ys.append(y)
    lib = cuda_build.library("conv3_tc", _ARGTYPES)
    rc = lib.unav_conv3_tc(len(xs), (ctypes.c_void_p * len(ptrs))(*ptrs),
                           (ctypes.c_long * len(ints))(*ints), hi.data_ptr(), lo.data_ptr(), n,
                           kc, int(relu), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, rc, "masked_conv3")
    masked_conv3.launches += 1
    return ys


def _forward(xs, masks, w, hi, lo, relu: bool) -> List[torch.Tensor]:
    if w.device.type == "cpu":
        return [masked_conv3_reference(x, w, m, relu) for x, m in zip(xs, masks)]
    return _launch(xs, masks, hi, lo, relu)


class MaskedConv3Function(torch.autograd.Function):
    """The levels' convs with the port's 3xTF32 products as their backward;
    the masks and the weight's halves get no grad."""

    @staticmethod
    def forward(ctx, w, hi, lo, relu, nlev, *tensors):
        xs, masks = tensors[:nlev], tensors[nlev:]
        ys = _forward(xs, masks, w, hi, lo, relu)
        ctx.relu, ctx.nlev = relu, nlev
        ctx.save_for_backward(w, *xs, *masks, *(ys if relu else ()))
        return tuple(ys)

    @staticmethod
    def backward(ctx, *gys):
        nlev = ctx.nlev
        w, *saved = ctx.saved_tensors
        xs, masks, ys = saved[:nlev], saved[nlev:2 * nlev], saved[2 * nlev:]
        n, kc, _ = w.shape
        need_x, need_w = ctx.needs_input_grad[5:5 + nlev], ctx.needs_input_grad[0]
        # the transposed conv's B: row tap * N + n, column c = W[n, c, tap]
        wt = w.permute(2, 0, 1).reshape(3 * n, kc) if any(need_x) else None
        dxs, dwk = [], None
        for lvl, (x, mask, gy) in enumerate(zip(xs, masks, gys)):
            b, t, _ = x.shape
            keep = ys[lvl] > 0 if ctx.relu else mask[..., None]
            ds = (gy * keep).reshape(b * t, n)
            dxs.append(tf32x3_products([dict(x=ds, w=wt, taps=3, tapdir=-1, seq=t,
                                             trans_b=True)])[0].reshape(b, t, kc)
                       if need_x[lvl] else None)
            if need_w:
                dwk = tf32x3_products([dict(x=ds, w=x.reshape(b * t, kc), btaps=3, seq=t,
                                            trans_a=True, trans_b=True, out=dwk,
                                            beta=dwk is not None)])[0]
        dw = dwk.reshape(n, 3, kc).permute(0, 2, 1) if need_w else None
        return (dw, None, None, None, None, *dxs, *([None] * nlev))


@spanned("unav.kernel.masked_conv3")
def masked_conv3(xs: Sequence[torch.Tensor], w: torch.Tensor, masks: Sequence[torch.Tensor],
                 *, relu: bool, split=None) -> List[torch.Tensor]:
    """The k=3 conv of W (N, Kc, 3) over each level's x (B, T_l, Kc) fp32,
    then the ReLU (relu) and the level's mask (B, T_l) bool: a (B, T_l, N)
    output a level, the levels (up to six) in one launch. `split` is
    `conv3_split(w)`, computed here if not given (a caller with several
    calls a step splits once). CPU tensors take the plain version; CUDA
    tensors launch the kernel. When a grad is needed the call goes through
    MaskedConv3Function."""
    xs, masks = list(xs), list(masks)
    hi, lo = conv3_split(w) if split is None else split
    if torch.is_grad_enabled() and (w.requires_grad or any(x.requires_grad for x in xs)):
        return list(MaskedConv3Function.apply(w, hi, lo, relu, len(xs), *xs, *masks))
    return _forward(xs, masks, w, hi, lo, relu)


masked_conv3.launches = 0
