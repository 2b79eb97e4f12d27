"""The plain version of the whole-block TBlock's MLP product
(ops/gemm_tc.py:mlp_product_reference, which `mlp_product` takes for CPU
tensors) against the plain versions it must agree with: the forward's
bf16 product (`bf16_product_reference`: fc1 + GELU, fc2's residual tail,
store with bias and row mask), the backward's strided product
(`bf16_layout_reference`, A.B) and GELU' applied to the rounded product.
Bit for bit: the same bf16 values through the same rounding steps."""

import numpy as np
import pytest
import torch

from unav_yolyolva_tpu_torch.ops.gemm_tc import (bf16_layout_reference, bf16_product_reference,
                                                 gelu_erf, gelu_erf_grad, mlp_product,
                                                 mlp_product_reference)
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)

BF = torch.bfloat16


def _operands(layout, m=20, n=16, k=40, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(BF)
    w = torch.from_numpy((rng.standard_normal((n, k) if layout == "nt" else (k, n))
                          / np.sqrt(k)).astype(np.float32)).to(BF)
    bias = torch.from_numpy(0.1 * rng.standard_normal(n).astype(np.float32)).to(BF)
    mask = torch.from_numpy(rng.random(m) > 0.3)
    return rng, x, w, bias, mask


@pytest.mark.parametrize("epi", ["raw", "store", "gelu", "ua", "res"])
def test_forward_layout_matches_the_forward_product(epi):
    rng, x, w, bias, mask = _operands("nt")
    kw, ref_kw = {}, {}
    if epi in ("store", "gelu", "ua", "res"):
        kw["bias"] = ref_kw["bias"] = bias
    if epi in ("store", "res"):
        kw["rowmask"] = ref_kw["rowmask"] = mask
    if epi == "res":
        out = torch.from_numpy(rng.standard_normal((20, 16)).astype(np.float32))
        seqmul = torch.from_numpy(1 + 0.3 * rng.standard_normal((4, 16)).astype(np.float32))
        kw.update(out=out, seqmul=seqmul, seq=5)
        ref_kw.update(out=out, seqmul=seqmul, seq=5)
    got = mlp_product(x, w, "nt", epi, **kw)
    if epi == "ua":
        u = bf16_product_reference(x, w, bias)
        assert torch.equal(got[0], u)
        assert torch.equal(got[1], gelu_erf(u.float()).to(BF))
        return
    ref = bf16_product_reference(x, w, ref_kw.pop("bias", None), raw=epi == "raw",
                                 act="gelu" if epi == "gelu" else "none", **ref_kw)
    assert got.dtype == ref.dtype and torch.equal(got, ref)


@pytest.mark.parametrize("epi", ["raw", "store", "du"])
def test_input_grad_layout_matches_the_strided_product(epi):
    rng, x, w, _, _ = _operands("nn")
    u = torch.from_numpy(rng.standard_normal((20, 16)).astype(np.float32)).to(BF)
    got = mlp_product(x, w, "nn", epi, u=u)
    y = bf16_layout_reference(x, w, "nn", out_bf16=epi != "raw")
    if epi == "du":
        y = (gelu_erf_grad(u.float()) * y.float()).to(BF)
    # the plain version sums in fp32, the strided one in fp64: both exact
    # products of bf16 values, so at most a rounding apart
    assert got.dtype == y.dtype
    assert float((got.float() - y.float()).abs().max()) <= 1e-2 * float(y.float().abs().max())
    if epi != "raw":
        assert (got != y).float().mean() <= 0.05


def test_weight_grad_layout_rounds_each_row_block():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((42, 16)).astype(np.float32)).to(BF)
    w = torch.from_numpy(rng.standard_normal((42, 24)).astype(np.float32)).to(BF)
    got = mlp_product(x, w, "tn", "raw", kblock=7)
    ref = sum((x[i:i + 7].T.double() @ w[i:i + 7].double()).float().to(BF).float()
              for i in range(0, 42, 7))
    assert got.dtype == torch.float32 and torch.equal(got, ref)


def test_refuses_an_epilogue_outside_its_layout():
    _, x, w, _, _ = _operands("nn")
    with pytest.raises(ValueError):
        mlp_product_reference(x, w, "nn", "gelu")
