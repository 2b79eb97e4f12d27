"""The dependency block's k=3 convolutions on the tensor cores
(`ops/conv3_tc.py`), on the CPU: the plain version that the kernel of
`csrc/conv3_tc.cu` repeats (3xTF32, each 32-deep slice of one tap summed
from zero, the slices in the order (channel block, tap)), against
`F.conv1d` in fp64 at reduced widths: its error within 2x that of the fp32
conv, where one TF32 rounding of the operands is far outside it; exact
zeros on masked rows and no reach across sequences; several levels in one
call; the weight's halves; and the gradients of the autograd Function
(the port's 3xTF32 backward products) against autograd through
`F.conv1d` in fp64, at the train path's gate (norm-wise <= 1e-4 per
tensor). The card runs the kernel against the same in
tests/test_torch_port_gpu.py."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)
from unav_yolyolva_tpu_torch.ops.conv3_tc import (conv3_split, masked_conv3,
                                                  masked_conv3_reference)
from unav_yolyolva_tpu_torch.ops.gemm_tc import SLICE, conv3_taps, tf32_round, tf32x3_split


def _case(seed, b, t, kc, n, lengths=None):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(b, t, kc)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(n, kc, 3)) / np.sqrt(3 * kc)).astype(np.float32))
    lengths = lengths or [t] * b
    mask = torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]
    return x, w, mask


def _conv(x, w, mask, relu):
    y = F.conv1d(x.transpose(1, 2), w, padding=1).transpose(1, 2)
    return (y.clamp_min(0) if relu else y) * mask[..., None].to(y.dtype)


def _err(y, ref):
    return float((y.double() - ref).norm() / ref.norm())


@pytest.mark.parametrize("b,t,kc,n,lengths,relu", [
    (4, 7, 96, 64, [7, 5, 1, 7], True),          # T = 7 (level 5), masked rows
    (2, 28, 64, 160, [28, 13], False),            # the squeeze's epilogue
    (3, 14, 40, 48, [14, 14, 9], True),           # Kc off the 32-channel blocks
    (2, 56, 128, 32, [56, 56], False),
])
def test_plain_version_error_within_twice_fp32(b, t, kc, n, lengths, relu):
    x, w, mask = _case(b * t + kc, b, t, kc, n, lengths)
    ref = _conv(x.double(), w.double(), mask, relu)
    e3 = _err(masked_conv3_reference(x, w, mask, relu), ref)
    e32 = _err(_conv(x, w, mask, relu), ref)
    e1 = _err(_conv(tf32_round(x), tf32_round(w), mask, relu), ref)
    assert e3 <= 2 * e32, (e3, e32)
    assert e1 > 10 * e32, "one TF32 rounding should be far outside the fp32 error"


def test_plain_version_sums_slices_in_the_kernels_order():
    """Each 32-channel block's three taps, one slice each, lo.hi + hi.lo
    then + hi.hi summed from zero, added to the total in the order (block,
    tap): the plain version gives these bits."""
    b, t, kc, n = 2, 9, 64, 16
    x, w, mask = _case(5, b, t, kc, n)
    a = conv3_taps(x.reshape(b * t, kc), t)                      # k = tap * kc + c
    wk = w.permute(0, 2, 1).reshape(n, 3 * kc)
    ah, al = tf32x3_split(a)
    wh, wl = tf32x3_split(wk)
    total = None
    for c0 in range(0, kc, SLICE):
        for tap in range(3):
            k = slice(tap * kc + c0, tap * kc + c0 + SLICE)
            part = al[:, k] @ wh[:, k].T + ah[:, k] @ wl[:, k].T
            part = part + ah[:, k] @ wh[:, k].T
            total = part if total is None else total + part
    assert torch.equal(masked_conv3_reference(x, w, mask), total.reshape(b, t, n))


def test_plain_version_masks_rows_and_keeps_to_each_sequence():
    """Masked rows are exactly 0 (also under the ReLU); the first and last
    frame of a sequence read zeros beyond it: another sample's frames do not
    move a sample's output."""
    x, w, mask = _case(6, 3, 7, 32, 24, [7, 4, 0])
    y = masked_conv3_reference(x, w, mask, relu=True)
    assert bool((y[~mask] == 0).all()) and bool((y[~mask].view(torch.int32) == 0).all())
    x2 = x.clone()
    x2[1] = torch.randn(7, 32)
    y2 = masked_conv3_reference(x2, w, mask, relu=True)
    assert torch.equal(y[0], y2[0]) and torch.equal(y[2], y2[2])


def test_levels_in_one_call_give_each_levels_result():
    """One call over levels of T = 28, 14, 7 that share the weight gives
    each level's result alone, and counts no launch on the CPU."""
    cases = [_case(10 + t, 2, t, 64, 48, [t, t // 2]) for t in (28, 14, 7)]
    w = cases[0][1]
    xs, masks = [c[0] for c in cases], [c[2] for c in cases]
    before = masked_conv3.launches
    together = masked_conv3(xs, w, masks, relu=True)
    alone = [masked_conv3([x], w, [m], relu=True)[0] for x, m in zip(xs, masks)]
    assert masked_conv3.launches == before
    for a, b in zip(together, alone):
        assert torch.equal(a, b)


def test_split_lays_the_weight_out_tap_major():
    """conv3_split: (N, Kc, 3) -> hi, lo (N, 3, Kc), hi = tf32(w), lo =
    tf32(w - hi)."""
    _, w, _ = _case(7, 1, 3, 12, 8)
    hi, lo = conv3_split(w)
    assert hi.shape == lo.shape == (8, 3, 12)
    wt = w.permute(0, 2, 1)
    assert torch.equal(hi, tf32_round(wt)) and torch.equal(lo, tf32_round(wt - hi))
    assert torch.equal(tf32_round(hi), hi) and torch.equal(tf32_round(lo), lo)


def _rel(got, ref):
    return float((got.double() - ref).norm() / ref.norm())


@pytest.mark.parametrize("relu", [True, False])
def test_grads_against_autograd_through_conv1d(relu):
    """Two levels sharing the weight (T = 20 and 7, padded rows): the input
    grads and the summed weight grad of the Function (the port's A.B and
    A^T.B 3xTF32 products) against autograd through F.conv1d in fp64,
    norm-wise within 1e-4; masked rows of the upstream grad reach nothing."""
    (x1, w, m1), (x2, _, m2) = _case(8, 3, 20, 64, 96, [20, 11, 3]), _case(9, 3, 7, 64, 96,
                                                                            [7, 7, 2])
    rng = np.random.default_rng(11)
    gs = [torch.from_numpy(rng.normal(size=(3, t, 96)).astype(np.float32)) for t in (20, 7)]
    xs = [x.clone().requires_grad_(True) for x in (x1, x2)]
    wg = w.clone().requires_grad_(True)
    ys = masked_conv3(xs, wg, [m1, m2], relu=relu)
    torch.autograd.backward(ys, gs)
    xr = [x.double().requires_grad_(True) for x in (x1, x2)]
    wr = w.double().requires_grad_(True)
    refs = [_conv(x, wr, m, relu) for x, m in zip(xr, (m1, m2))]
    torch.autograd.backward(refs, [g.double() for g in gs])
    assert _rel(wg.grad, wr.grad) <= 1e-4
    for x, r in zip(xs, xr):
        assert _rel(x.grad, r.grad) <= 1e-4
    # the output's forward is the plain version's
    for y, x, m in zip(ys, (x1, x2), (m1, m2)):
        assert torch.equal(y.detach(), masked_conv3_reference(x, w, m, relu))
