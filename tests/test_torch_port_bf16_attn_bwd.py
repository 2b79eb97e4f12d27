"""The plain version of the bf16 MHCA backward's fused attention backward
(`ops/fused_mhca.py:attention_backward_reference`, which the card's kernel
is held against) on the CPU: without its bf16 roundings it is the gradient
of masked softmax attention (against fp64 autograd, norm-wise within 1e-5:
fp32 sums); with them it stays a bf16 distance away (within 1e-2) in both
forms; a sequence without a valid key gets exact zeros, a masked key a zero
dv; on CPU tensors the wrapper is the plain version; in the hand form it is
bit for bit the attention part of the bf16 MHCA backward's plain version
(`_mhca_backward_bf16_reference`, which follows the JAX kernel)."""

import math
import sys

import numpy as np
import pytest
import torch

from unav_yolyolva_tpu_torch.ops.fused_mhca import (_mhca_backward_bf16_reference,
                                                    attention_backward,
                                                    attention_backward_reference)
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)

BF = torch.bfloat16


def _case(t, c, heads, lengths, seed):
    rng = np.random.default_rng(seed)
    r = len(lengths)
    q = torch.from_numpy(rng.standard_normal((r, t, c)) * (c // heads) ** -0.5).to(BF)
    k, v, go = (torch.from_numpy(rng.standard_normal((r, t, c))).to(BF) for _ in range(3))
    mask = torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]
    return q, k, v, go, mask


def _autograd64(q, k, v, go, mask, heads):
    """(dq, dk, dv) of o = softmax(q k^T, masked) v in fp64; dq times the
    bf16 scale the kernel applies (q arrives scaled)."""
    r, t, c = q.shape
    d = c // heads
    qd, kd, vd = (x.double().requires_grad_() for x in (q, k, v))
    qh, kh, vh = (x.reshape(r, t, heads, d).transpose(1, 2) for x in (qd, kd, vd))
    logits = (qh @ kh.transpose(-1, -2)).masked_fill(~mask[:, None, None, :], -1e300)
    any_kv = mask.any(-1)[:, None, None, None]
    att = torch.where(any_kv, logits, torch.zeros((), dtype=torch.float64)).softmax(-1) * any_kv
    (att @ vh).transpose(1, 2).reshape(r, t, c).backward(go.double())
    scale = float(torch.tensor(1.0 / math.sqrt(d), dtype=BF))
    return qd.grad * scale, kd.grad, vd.grad


def _rel(a, b):
    return float((a.double() - b).norm() / b.norm())


@pytest.mark.parametrize("vjp", [False, True])
@pytest.mark.parametrize("t,c,heads,lengths", [(40, 64, 4, [40, 17, 0]),
                                               (70, 256, 2, [70, 33])])
def test_plain_attention_backward_is_the_attention_grad(t, c, heads, lengths, vjp):
    q, k, v, go, mask = _case(t, c, heads, lengths, seed=t + heads)
    exact = _autograd64(q, k, v, go, mask, heads)
    unrounded = attention_backward_reference(q, k, v, go, mask, heads=heads, vjp=vjp,
                                             rounded=False)
    rounded = attention_backward_reference(q, k, v, go, mask, heads=heads, vjp=vjp)
    for u, b, e in zip(unrounded, rounded, exact):
        assert u.dtype == torch.float32 and b.dtype == BF
        assert _rel(u, e) <= 1e-5
        assert 1e-4 <= _rel(b.float(), e) <= 1e-2


def test_plain_attention_backward_zeros_and_the_cpu_wrapper():
    q, k, v, go, mask = _case(50, 64, 4, [50, 20, 0], seed=3)
    for vjp in (False, True):
        got = attention_backward(q, k, v, go, mask, heads=4, vjp=vjp)
        ref = attention_backward_reference(q, k, v, go, mask, heads=4, vjp=vjp)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        assert all((x[2] == 0).all() for x in got)
        assert (got[2][1, 20:] == 0).all() and not (got[2][1, :20] == 0).all()


def _locals_at_return(fn, *args, **kwargs):
    """fn's local variables as it returns (read through sys.setprofile)."""
    seen = {}

    def watch(frame, event, arg):
        if event == "return" and frame.f_code is fn.__code__:
            seen.update(frame.f_locals)

    sys.setprofile(watch)
    try:
        fn(*args, **kwargs)
    finally:
        sys.setprofile(None)
    return seen


@pytest.mark.parametrize("t,c,heads,lengths", [(40, 64, 4, [40, 17, 0]),
                                               (70, 256, 2, [70, 33])])
def test_plain_attention_backward_is_the_mhca_reference_attention(t, c, heads, lengths):
    """In the hand form the plain attention backward is, bit for bit, the
    attention part of the bf16 MHCA backward's plain version: its dq, dk, dv
    from that version's own q, k, v and g_o."""
    rng = np.random.default_rng(t + c)
    r = len(lengths)

    def rnd(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape) * scale).float()

    mask = torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]
    x1, x2, g = (rnd(r, t, c).to(BF) for _ in range(3))
    weights = (rnd(3, c, 3, scale=0.5), 1 + rnd(3, c, scale=0.1), rnd(3, c, scale=0.1),
               rnd(4, c, c, scale=c ** -0.5), rnd(4, c, scale=0.1))
    seen = _locals_at_return(_mhca_backward_bf16_reference, x1, x2, mask, *weights, g,
                             heads=heads)
    got = attention_backward_reference(seen["q"], seen["k"], seen["v"], seen["g_o"], mask,
                                       heads=heads)
    for name, x in zip(("dq", "dk", "dv"), got):
        assert x.dtype == seen[name].dtype and torch.equal(x, seen[name]), name
