"""The bf16 compute policy's gradients as the JAX package's program takes them.

The JAX Pallas backward kernels of the CSP layer and the whole
TransformerBlock (`_csp_bwd_kernel`, `_tblock_bwd_kernel`) are `jax.vjp` of
their bf16 forward bodies, run once per block of R rows of the batch. Most of
that autodiff program is what PyTorch's autograd of the port's plain bf16
forward computes too: a product's input grad is the fp32 sum rounded to bf16,
a weight cast with `.astype(bf16)` gets its fp32 sum rounded to bf16 and
converted back. Three things are not, and this module holds them:

- A bf16 value broadcast into a bf16 op (a bias `y + b.astype(bf16)`, the
  depthwise taps `x * w.astype(bf16)`, the CSP gate `pc * gate`) gets the
  bf16 sum of the cotangent (times the other factor, rounded) over the
  broadcast dims. XLA:CPU takes that reduction in bf16, each partial sum
  rounded, in the order of its tree-reduction rewrite: a reduced dimension
  longer than 32 is padded with zeros to a multiple of 32 (half of them
  before it, the rest after) and summed in windows of 32, each window
  sequentially in row-major order over the reduced dims, and the window
  sums are reduced again the same way; a reduction whose dims are all at
  most 32 long is one sequential pass (`xla_sum`; `BroadcastMul` and
  `bias_add` give autograd that reduction).
- Each block's bf16 weight grads are rounded once per block and the blocks
  are then added in fp32, in order (`row_blocks`): the port runs its plain
  backward once per block of the JAX kernel's rows (`pick_rows_csp_bwd`,
  `pick_rows_tb_bwd`, copies of the JAX package's pickers at bf16).
- The CSP layer pads T to a multiple of 8 before its kernels (the zero rows
  move the reduction windows above).

The standalone MHCA's backward (`_mhca_bwd_kernel`) is written by hand in the
JAX package and keeps its weight grads in fp32; its plain version is
`fused_mhca.mhca_backward_reference`.
"""

from __future__ import annotations

from typing import Sequence

import torch

WINDOW = 32     # XLA:CPU's tree-reduction window


def _sequential(x: torch.Tensor, n: int) -> torch.Tensor:
    """bf16 sum over the first n-element axis of x (n, ...), in order, each
    partial sum rounded."""
    s = x[0]
    for i in range(1, n):
        s = s + x[i]
    return s


def xla_sum(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """The bf16 sum of bf16 x over `dims` as XLA:CPU reduces it (module
    docstring): the result has x's other dims, in order."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"xla_sum: bf16 input, got {x.dtype}")
    dims = sorted(d % x.dim() for d in dims)
    rest = [d for d in range(x.dim()) if d not in dims]
    x = x.permute(*dims, *rest)
    nd = len(dims)
    while any(s > WINDOW for s in x.shape[:nd]):
        counts, wins, pads = [], [], []
        for s in x.shape[:nd]:
            if s > WINDOW:
                p = -s % WINDOW
                pads = [p // 2, p - p // 2] + pads
                counts.append((s + p) // WINDOW)
                wins.append(WINDOW)
            else:
                pads = [0, 0] + pads
                counts.append(1)
                wins.append(s)
        tail = list(x.shape[nd:])
        x = torch.nn.functional.pad(x, [0, 0] * len(tail) + pads)
        x = x.reshape([v for cw in zip(counts, wins) for v in cw] + tail)
        x = x.permute(*range(1, 2 * nd, 2), *range(0, 2 * nd, 2),
                      *range(2 * nd, 2 * nd + len(tail)))
        n = 1
        for w in wins:
            n *= w
        x = _sequential(x.reshape([n] + counts + tail), n)
    n = 1
    for s in x.shape[:nd]:
        n *= s
    return _sequential(x.reshape([n] + list(x.shape[nd:])), n)


class BroadcastMul(torch.autograd.Function):
    """x * w in bf16 with w broadcast over x (fewer or size-1 dims); w's
    grad is the bf16 product of x and the cotangent, summed by `xla_sum`
    over the broadcast dims."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x * w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = g * w if ctx.needs_input_grad[0] else None
        gw = None
        if ctx.needs_input_grad[1]:
            lead = x.dim() - w.dim()
            dims = list(range(lead)) + [lead + i for i, s in enumerate(w.shape)
                                        if s == 1 and x.shape[lead + i] != 1]
            gw = xla_sum(x * g, dims).reshape(w.shape)
        return gx, gw


def broadcast_mul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x * w with w's bf16 grad reduced as XLA:CPU reduces it (bf16 only)."""
    if x.dtype != torch.bfloat16 or not torch.is_grad_enabled():
        return x * w
    return BroadcastMul.apply(x, w)


class BiasAdd(torch.autograd.Function):
    """y (..., N) + b (N,) in bf16; b's grad is `xla_sum` of the cotangent
    over the rows of its (M, N) view (the JAX products add their bias to the
    2-d (rows, N) result)."""

    @staticmethod
    def forward(ctx, y, b):
        return y + b

    @staticmethod
    def backward(ctx, g):
        gb = xla_sum(g.reshape(-1, g.shape[-1]), (0,)) if ctx.needs_input_grad[1] else None
        return g, gb


def bias_add(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """y + b with b's bf16 grad reduced as XLA:CPU reduces it (bf16 only)."""
    if y.dtype != torch.bfloat16 or not torch.is_grad_enabled():
        return y + b
    return BiasAdd.apply(y, b)


class FanOut(torch.autograd.Function):
    """n uses of one bf16 tensor whose grads are added in the order of the
    uses (each partial sum rounded), as JAX's backward pass accumulates the
    cotangents of a value used several times."""

    @staticmethod
    def forward(ctx, x, n):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *gs):
        total = None
        for g in gs:
            if g is not None:
                total = g if total is None else total + g
        return total, None


def fan_out(x: torch.Tensor, n: int):
    """n aliases of x whose grads add in the order given (bf16 only; else n
    times x)."""
    if x.dtype != torch.bfloat16 or not torch.is_grad_enabled() or not x.requires_grad:
        return (x,) * n
    return FanOut.apply(x, n)


def row_blocks(backward, rows: int, batch_args, shared_args, n_batch_grads: int):
    """Run `backward(*batch_slices, *shared_args)` once per block of `rows`
    rows of the batch tensors `batch_args` (the JAX kernel's grid): its first
    n_batch_grads outputs are per-row grads, concatenated over the blocks;
    the others are weight grads, converted to fp32 and added over the blocks
    in order, as the JAX kernel accumulates them."""
    b = batch_args[0].shape[0]
    out = None
    for r0 in range(0, b, rows):
        grads = backward(*[a[r0:r0 + rows] for a in batch_args], *shared_args)
        if out is None:
            out = [[gr] for gr in grads[:n_batch_grads]] + [gr.float()
                                                            for gr in grads[n_batch_grads:]]
            continue
        for i, gr in enumerate(grads):
            if i < n_batch_grads:
                out[i].append(gr)
            else:
                out[i] = out[i] + gr.float()
    return tuple(torch.cat(o) if i < n_batch_grads else o for i, o in enumerate(out))


def pick_rows_csp_bwd(b: int, t: int, cin: int, mid: int, ng: int, fg: int, emb: int,
                      cout: int, itemsize: int, attn_heads: int, mhca_heads: int) -> int:
    """The JAX CSP backward kernel's batch block R (ops/pallas_csp.py:
    `_pick_rows_csp_bwd`, a VMEM budget on the TPU): the largest power-of-two
    divisor of b under the budget. t is the padded length (a multiple of 8)."""
    budget = 60 * 1024 * 1024
    windows = 2 * (2 * t * cin + 2 * ng * fg + t + 2 * t * cout) * itemsize
    live = ((40 * t * mid + 2 * ng * emb + 2 * t * cin + 2 * t * cout) * itemsize
            + (3 * 2 * mhca_heads * t * t + 2 * attn_heads * t * ng + 8 * t * mid) * 4)
    per_row = windows + 2 * live
    r = b
    while r > 1:
        if r * per_row <= budget and b % r == 0:
            return r
        r //= 2
    return 1


def pick_rows_tb_bwd(b: int, t: int, c: int, hidden: int, heads: int, itemsize: int) -> int:
    """The JAX TBlock backward kernel's batch block R (ops/pallas_tblock.py:
    `_pick_rows_tb_bwd`)."""
    budget = 44 * 1024 * 1024
    r = b
    while r > 1:
        act = 30 * r * t * c * itemsize + 6 * r * t * c * 4
        mlp = 2 * r * t * hidden * itemsize + r * t * hidden * (4 - itemsize)
        att = 4 * r * heads * t * t * 4
        if 2 * (act + mlp + att) <= budget and b % r == 0:
            return r
        r //= 2
    return 1
