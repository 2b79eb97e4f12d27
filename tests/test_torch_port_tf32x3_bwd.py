"""The backward layouts of the port's tensor-core product, on the CPU.

`csrc/gemm_tc.cuh` runs the backward kernels' products in two more layouts
than the forward's A.B^T: A.B (input grads; B stored (K, N); A optionally
the transposed k=3 conv, whose taps read row m - (tap - 1); optionally
added into the output) and A^T.B (weight grads summed over all R*T rows; A
stored (K, M) with masked k rows; B optionally the k=3 conv's shifted rows;
K split into chunks fixed by the product's own shape, each summed from
zero, then added in order). `ops/gemm_tc.py:tf32x3_product_reference`
emulates them with the kernel's rounding, slice and chunk order. These
tests hold that emulation against an fp64 product: its norm-wise error
within 2x that of the fp32 matmul at the same shapes, the CSP backward's
shapes cut to a CPU's size; and they check that the loaders' operands are
what the backward needs (the transposed conv is the forward conv's
adjoint, the shifted B rows give the conv's weight grad).
"""

import numpy as np
import pytest
import torch

from unav_yolyolva_tpu_torch.ops.gemm_tc import (SLICE, conv3_taps, split_chunk,
                                                 tf32x3_product_reference, tf32x3_products)
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))


def _errs(y, y32, ref):
    def err(v):
        return float((v.double() - ref).norm() / ref.norm())
    return err(y), err(y32)


@pytest.mark.parametrize("m,kc,n,seq,beta", [
    (896, 256, 256, 7, True),      # projection conv input grad at T=7 (2B=128), into dcat
    (448, 128, 192, 14, False),
    (1000, 512, 384, 1, True),     # a plain input grad, ragged M
])
def test_input_grad_layout_error_within_twice_fp32(m, kc, n, seq, beta):
    rng = np.random.default_rng(m + n)
    taps = 3 if seq > 1 else 1
    x = _rand(rng, m, kc)
    w = _rand(rng, taps * kc, n, scale=1 / np.sqrt(taps * kc))      # stored (K, N)
    out = _rand(rng, m, n) if beta else None
    a = conv3_taps(x, seq, -1) if taps == 3 else x
    ref = a.double() @ w.double() + (out.double() if beta else 0)
    y32 = a @ w + (out if beta else 0)
    y = tf32x3_product_reference(x, w, taps=taps, tapdir=-1, seq=seq, trans_b=True,
                                 out=out, beta=beta)
    e3, e32 = _errs(y, y32, ref)
    assert e3 <= 2 * e32, f"3xTF32 {e3:.3e} vs fp32 {e32:.3e}"


@pytest.mark.parametrize("k,m,n,seq,masked", [
    (1001, 128, 128, 7, True),     # conv weight grad over 143 sequences of 7, ragged K
    (1792, 256, 768, 1, True),     # final-conv-like weight grad: 6 chunks, the last ragged
    (4096, 128, 224, 1, False),    # guide_fc weight grad over R*Ng rows: 8 chunks
])
def test_weight_grad_layout_error_within_twice_fp32(k, m, n, seq, masked):
    rng = np.random.default_rng(k + m)
    btaps = 3 if seq > 1 else 1
    x = _rand(rng, k, m)                                            # stored (K, M)
    w = _rand(rng, k, n)
    kmask = torch.from_numpy(rng.random(k) > 0.2) if masked else None
    a = x * kmask[:, None] if masked else x
    b = conv3_taps(w, seq) if btaps == 3 else w
    ref = a.double().T @ b.double()
    y32 = a.T @ b
    y = tf32x3_product_reference(x, w, kmask=kmask, btaps=btaps, seq=seq, trans_a=True,
                                 trans_b=True)
    assert y.shape == (m, btaps * n)
    e3, e32 = _errs(y, y32, ref)
    assert e3 <= 2 * e32, f"3xTF32 {e3:.3e} vs fp32 {e32:.3e}"


@pytest.mark.parametrize("m,n,k", [(512, 1536, 3584), (256, 256, 3584), (256, 224, 8192),
                                   (512, 1536, 112), (64, 64, 1001)])
def test_split_chunk_is_whole_slices_fixed_by_the_shape(m, n, k):
    chunk = split_chunk(m, n, k)
    chunks = -(-k // chunk)
    assert chunk % SLICE == 0 and 1 <= chunks <= 8
    assert chunks == 1 or chunk >= 8 * SLICE        # each split at least 8 slices deep
    # chunks of a weight grad with few output tiles fill ~2 blocks a SM
    tiles = -(-m // 64) * -(-n // 64)
    assert chunks == 1 or tiles * (chunks - 1) < 2 * 132


def test_transposed_conv_is_the_adjoint_of_the_forward_conv():
    """The A.B loader with tapdir -1 over wprojT [tap, out, in] gives the k=3
    conv's input grad, and the A^T.B loader with btaps 3 its weight grad
    (the CSP backward's projection conv)."""
    rng = np.random.default_rng(3)
    seq, kc, n = 7, 16, 12
    x = _rand(rng, 4 * seq, kc).requires_grad_(True)
    wtaps = _rand(rng, n, 3 * kc).requires_grad_(True)       # [out, (tap, in)], the forward's
    dy = _rand(rng, 4 * seq, n)
    (conv3_taps(x, seq) @ wtaps.T).backward(dy)
    wprojT = wtaps.detach().reshape(n, 3, kc).permute(1, 0, 2).reshape(3 * n, kc)
    dx = tf32x3_product_reference(dy, wprojT, taps=3, tapdir=-1, seq=seq, trans_b=True)
    torch.testing.assert_close(dx, x.grad, rtol=1e-5, atol=1e-5)
    dw = tf32x3_product_reference(dy, x.detach(), btaps=3, seq=seq, trans_a=True, trans_b=True)
    torch.testing.assert_close(dw, wtaps.grad, rtol=1e-5, atol=1e-5)


def test_products_batch_layouts_on_the_cpu():
    """tf32x3_products takes every layout at once and writes into out."""
    rng = np.random.default_rng(4)
    x, w = _rand(rng, 64, 32), _rand(rng, 32, 48)
    out = torch.zeros(64, 48)
    kmask = torch.from_numpy(rng.random(64) > 0.5)
    a, b = tf32x3_products([dict(x=x, w=w, trans_b=True, out=out, beta=True),
                            dict(x=x, w=_rand(rng, 64, 16), kmask=kmask, trans_a=True,
                                 trans_b=True)])
    assert a is out and b.shape == (32, 16)
    torch.testing.assert_close(a, x @ w, rtol=1e-5, atol=1e-5)
