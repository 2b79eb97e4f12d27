"""Every product of the plain reference goes through this module, so that one
switch runs the whole reference at a precision below float32: the
correctness check's control (float32 is the reference itself).

    with precision("tf32"):     # operands rounded to TF32, fp32 sums
        ...
    with precision("fp8"):      # operands rounded to float8 e4m3 with a
        ...                     # per-tensor scale, fp32 sums

TF32 rounds each operand to 10 mantissa bits, to nearest, as the tensor
cores' TF32 mode reads fp32 inputs; the sums stay fp32. fp8 is a compute
dtype, as bf16 is the program's under its bf16 policy: each operand and
each product's fp32 sum is rounded to float8_e4m3fn, scaled per tensor so
that its largest magnitude is e4m3's 448. In a training step the
backward's products read rounded operands too: each product's output
rounds the gradient that flows back into it, and each operand passes its
gradient straight through its rounding. Elementwise work (softmax, norms,
activations, losses) stays fp32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_ROUND = [(None, None)]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 to the nearest TF32 value (ties to even), kept in fp32."""
    xi = x.float().contiguous().view(torch.int32)
    xi = (xi + 0x0FFF + ((xi >> 13) & 1)) & ~0x1FFF
    return xi.view(torch.float32)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 through float8_e4m3fn with a per-tensor scale to 448."""
    x = x.float()
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


# (operand and gradient rounding, product output rounding) of each precision
ROUNDERS = {"fp32": (None, None), "tf32": (tf32_round, None), "fp8": (fp8_round, fp8_round)}


@contextlib.contextmanager
def precision(name: str):
    """Run the products inside at precision `name` (one of ROUNDERS)."""
    saved = _ROUND[0]
    _ROUND[0] = ROUNDERS[name]
    try:
        yield
    finally:
        _ROUND[0] = saved


class _GradRound(torch.autograd.Function):
    """Identity forward; rounds the gradient flowing back."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def _through(x: torch.Tensor, fn) -> torch.Tensor:
    """fn(x), the gradient passed straight through."""
    if x.requires_grad:
        return x + (fn(x) - x).detach()
    return fn(x)


def r(x: torch.Tensor) -> torch.Tensor:
    """An operand of a product at the current precision."""
    fn = _ROUND[0][0]
    return x if fn is None else _through(x, fn)


def out(y: torch.Tensor) -> torch.Tensor:
    """A product's output at the current precision; its gradient is rounded
    on the way back."""
    fn, keep = _ROUND[0]
    if fn is None:
        return y
    if y.requires_grad:
        y = _GradRound.apply(y, fn)
    return y if keep is None else _through(y, keep)


def linear(x, w, b=None):
    y = F.linear(r(x), r(w))
    return out(y) if b is None else out(y) + b


def matmul(a, b):
    return out(torch.matmul(r(a), r(b)))


def einsum(eq: str, a, b):
    return out(torch.einsum(eq, r(a), r(b)))


def conv1d(x, w, b=None, stride: int = 1, padding: int = 0, groups: int = 1):
    y = out(F.conv1d(r(x), r(w), None, stride, padding, 1, groups))
    return y if b is None else y + b[:, None]
