"""The epilogue of the port's tensor-core product, and the whole-block
TransformerBlock routed through the 3xTF32 emulation, on the CPU.

`ops/gemm_tc.py` emulates the epilogue that `csrc/gemm_tc.cuh` applies to
the TBlock MLP's products: exact erf GELU (with its input kept beside it),
the product with GELU'(aux) on the A.B layout, and the per-sequence column
multiplier with the row mask and beta on the forward layout. Against an
fp64 product with the same epilogue, its norm-wise error stays within 2x
that of fp32 torch.matmul followed by the epilogue, at the fc1 / fc2 / du
shapes of a small block with ragged M. Then `tblock_reference` with every
product routed through the emulation (its dense layers, MLP and attention)
against the JAX `tblock_reference` and the Pallas `tblock_fused` in
interpret mode, at tests/test_torch_port_tblock.py's TOL."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unav_yolyolva_tpu.ops.pallas_tblock import tblock_fused as jtblock_fused
from unav_yolyolva_tpu.ops.pallas_tblock import tblock_reference as jtblock_reference
from unav_yolyolva_tpu_torch.ops.fused_tblock import tblock_reference
from unav_yolyolva_tpu_torch.ops.gemm_tc import (gelu_erf, gelu_erf_grad,
                                                 tf32x3_linear_reference,
                                                 tf32x3_matmul_reference,
                                                 tf32x3_product_reference, tf32x3_products)
from tests._torch_port_common import close, t
from tests.test_torch_port_tblock import HEADS, TOL, _case, _to_port
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)

TF32 = dict(linear=tf32x3_linear_reference, matmul=tf32x3_matmul_reference)
SEQ = 50                                     # rows per sequence of a ragged M = 3 * SEQ


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.normal(size=shape)).astype(np.float32))


def _err(y, ref):
    return float((y.double() - ref).norm() / ref.norm())


@pytest.mark.parametrize("m,n,k", [(3 * SEQ, 512, 128), (3 * SEQ, 256, 64)])
def test_gelu_epilogue_within_twice_fp32(m, n, k):
    """fc1 + bias + GELU, its input written to pre_out: bit-equal to the
    same product without the epilogue."""
    rng = np.random.default_rng(m + n)
    x, w, b = _rand(rng, m, k), _rand(rng, n, k, scale=k ** -0.5), _rand(rng, n, scale=0.5)
    pre = torch.empty(m, n)
    y = tf32x3_product_reference(x, w, b, act="gelu", pre_out=pre)
    ref = gelu_erf(x.double() @ w.double().T + b.double())
    assert _err(y, ref) <= 2 * _err(gelu_erf(x @ w.T + b), ref)
    assert torch.equal(pre, tf32x3_product_reference(x, w, b))
    assert torch.equal(y, gelu_erf(pre))


@pytest.mark.parametrize("m,n,k", [(3 * SEQ, 512, 128), (3 * SEQ, 256, 64)])
def test_gelu_grad_epilogue_on_the_input_grad_layout(m, n, k):
    """du = (gy W2) * GELU'(u): A.B with w stored (K, N)."""
    rng = np.random.default_rng(m + n + 1)
    gy, w2, u = _rand(rng, m, k), _rand(rng, k, n, scale=k ** -0.5), _rand(rng, m, n)
    y = tf32x3_product_reference(gy, w2, trans_b=True, act="gelu_grad", aux=u)
    ref = (gy.double() @ w2.double()) * gelu_erf_grad(u.double())
    assert _err(y, ref) <= 2 * _err((gy @ w2) * gelu_erf_grad(u), ref)


@pytest.mark.parametrize("m,n,k", [(3 * SEQ, 128, 512), (3 * SEQ, 64, 256)])
def test_seqmul_rowmask_beta_on_the_forward_layout(m, n, k):
    """fc2's tail: out + (h W2^T + b2) * rowmask * mult_m[sequence]."""
    rng = np.random.default_rng(m + n + 2)
    h, w, b = _rand(rng, m, k), _rand(rng, n, k, scale=k ** -0.5), _rand(rng, n, scale=0.5)
    res, mult = _rand(rng, m, n), 1.0 + _rand(rng, m // SEQ, n, scale=0.3)
    mask = torch.from_numpy(rng.uniform(size=m) < 0.8)
    y = tf32x3_product_reference(h, w, b, rowmask=mask, seqmul=mult, seq=SEQ, out=res,
                                 beta=True)
    mm, rows = mask[:, None].double(), mult.double().repeat_interleave(SEQ, 0)
    ref = res.double() + (h.double() @ w.double().T + b.double()) * mm * rows
    want = res + (h @ w.T + b) * mask[:, None].float() * mult.repeat_interleave(SEQ, 0)
    assert _err(y, ref) <= 2 * _err(want, ref)
    assert torch.equal(y[~mask], res[~mask])          # masked rows keep the residual


def test_products_run_an_epilogue_alone():
    """tf32x3_products takes the epilogue on CPU tensors (the plain
    version, written into out with beta) and refuses it in a batch."""
    rng = np.random.default_rng(5)
    x, w, b = _rand(rng, 2 * SEQ, 64), _rand(rng, 32, 64), _rand(rng, 32)
    mult, out = _rand(rng, 2, 32), _rand(rng, 2 * SEQ, 32)
    want = tf32x3_product_reference(x, w, b, seqmul=mult, seq=SEQ, out=out.clone(), beta=True)
    got = tf32x3_products([dict(x=x, w=w, bias=b, seqmul=mult, seq=SEQ, out=out,
                                beta=True)])[0]
    assert got is out and torch.equal(got, want)
    with pytest.raises(ValueError, match="alone"):
        tf32x3_products([dict(x=x, w=w, act="gelu"), dict(x=x, w=w)])
    with pytest.raises(ValueError, match="act"):
        tf32x3_product_reference(x, w, act="relu")


@pytest.mark.parametrize("lengths", [[16, 16, 16], [16, 5, 0]])
def test_tblock_reference_through_tf32x3_vs_jax_and_pallas(lengths):
    x, mask, ma, mm, packs, _ = _case(0, lengths)
    jargs = [jnp.asarray(a) for a in (x, mask, ma, mm, *packs)]
    port = tblock_reference(t(x), t(mask), t(ma), t(mm), *map(t, _to_port(*packs)),
                            heads=HEADS, **TF32)
    close(port, jtblock_reference(*jargs, heads=HEADS), rtol=TOL, atol=TOL)
    close(port, jtblock_fused(*jargs, heads=HEADS, interpret=True), rtol=TOL, atol=TOL)
