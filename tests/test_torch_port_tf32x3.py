"""The numerical design of the port's tensor-core product on the CPU.

`ops/gemm_tc.py` emulates the kernels' 3xTF32 scheme: each operand split
as hi = tf32(x), lo = tf32(x - hi) (round to nearest, ties away), lo.hi +
hi.lo + hi.hi summed in fp32 per 32-deep slice of k, the lo.lo term
dropped. These tests show, before any card time, that the scheme holds the
port's fp32 gates:
- at the CSP layer's product shapes (main / final conv, guide_fc, the k=3
  projection conv, ragged M) its error against an fp64 product is within
  2x that of the fp32 matmul, where one TF32 pass is far outside it;
- with every product of the plain MHCA and CSP versions routed through it
  (dense layers, convs, the attention's two products), both still match
  the JAX package's Pallas kernels in interpret mode at the module-parity
  tolerances (rtol 1e-4, atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import unav_yolyolva_tpu.models.blocks as jblocks
from unav_yolyolva_tpu.models.fusion import MaxSigmoidCSPLayer as JCSP
from unav_yolyolva_tpu.ops.pallas_csp import csp_fused, pack_csp_params
from unav_yolyolva_tpu.ops.pallas_fusion import mhca_fused, pack_mhca_params
from unav_yolyolva_tpu_torch.models.blocks import MaskedMHCA
from unav_yolyolva_tpu_torch.models.fusion import MaxSigmoidCSPLayer
from unav_yolyolva_tpu_torch.ops.fused_csp import csp_reference
from unav_yolyolva_tpu_torch.ops.fused_mhca import mhca_reference
from unav_yolyolva_tpu_torch.ops.gemm_tc import (conv3_taps, tf32_round, tf32x3_linear,
                                                 tf32x3_linear_reference,
                                                 tf32x3_matmul_reference, tf32x3_products,
                                                 tf32x3_split)
from unav_yolyolva_tpu_torch.utils.convert import csp_entries, mhca_entries
from tests._torch_port_common import close, lengths_mask, load_port, np_tree, t
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)

TF32 = dict(linear=tf32x3_linear_reference, matmul=tf32x3_matmul_reference)


def test_tf32_round_is_round_to_nearest_ties_away():
    one_ulp = 2.0 ** -10                                       # TF32's last kept bit at 1
    x = torch.tensor([1.0, 1 + one_ulp / 2, 1 + 1.5 * one_ulp, -(1 + one_ulp / 2),
                      1 + 0.49 * one_ulp, 3.0, -0.0, 2.0 ** -120])
    want = [1.0, 1 + one_ulp, 1 + 2 * one_ulp, -(1 + one_ulp), 1.0, 3.0, -0.0, 2.0 ** -120]
    assert tf32_round(x).tolist() == want
    r = torch.from_numpy(np.random.default_rng(0).normal(size=10000).astype(np.float32))
    hi, lo = tf32x3_split(r)
    assert (tf32_round(hi) == hi).all() and (tf32_round(lo) == lo).all()
    # hi + lo keeps ~22 of fp32's 24 bits
    assert float(((hi.double() + lo.double() - r.double()).abs() / r.double().abs()).max()) \
        <= 2.0 ** -21


def _operands(rng, m, n, k, taps):
    kc = k // taps
    x = torch.from_numpy(rng.normal(size=(m, kc)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32))
    return x, w


@pytest.mark.parametrize("m,n,k,taps,seq", [
    (896, 512, 1536, 1, 1),       # final conv, T=7 (2B=128)
    (1000, 512, 1024, 1, 1),      # main conv, ragged M
    (896, 256, 768, 3, 7),        # k=3 projection conv over sequences of 7
    (1792, 256, 768, 3, 14),
    (2048, 256, 224, 1, 1),       # guide_fc (Fg = 224)
])
def test_tf32x3_product_error_within_twice_fp32(m, n, k, taps, seq):
    x, w = _operands(np.random.default_rng(m + k), m, n, k, taps)
    a = conv3_taps(x, seq) if taps == 3 else x
    ref = a.double() @ w.double().T

    def err(y):
        return float((y.double() - ref).norm() / ref.norm())

    e3 = err(tf32x3_linear_reference(x, w, taps=taps, seq=seq))
    e32 = err(a @ w.T)
    e1 = err(tf32_round(a) @ tf32_round(w).T)
    assert e3 <= 2 * e32, (e3, e32)
    assert e1 > 10 * e32, "one TF32 pass should be far outside the fp32 error"


def test_conv3_taps_is_the_same_conv():
    rng = np.random.default_rng(3)
    r, tt, c = 3, 7, 8
    x = torch.from_numpy(rng.normal(size=(r, tt, c)).astype(np.float32))
    wconv = torch.from_numpy(rng.normal(size=(c, c, 3)).astype(np.float32))
    ref = F.conv1d(x.transpose(1, 2), wconv, padding=1).transpose(1, 2)
    got = conv3_taps(x.reshape(r * tt, c), tt) @ wconv.permute(0, 2, 1).reshape(c, 3 * c).T
    torch.testing.assert_close(got.reshape(r, tt, c), ref, rtol=1e-5, atol=1e-5)


def test_products_on_cpu_take_the_plain_version_into_strided_outputs():
    """The CPU path of the wrapper: the plain version, written into a column
    slice of a wider buffer as the CSP concat is, with bias, scale and a row
    mask; no launch is counted."""
    rng = np.random.default_rng(4)
    x, w = _operands(rng, 14, 8, 12, 1)
    x2, w2 = _operands(rng, 14, 4, 24, 3)
    bias = torch.from_numpy(rng.normal(size=8).astype(np.float32))
    rowmask = torch.arange(14) % 5 != 0
    cat = torch.full((14, 20), 7.0)
    before = tf32x3_linear.launches
    outs = tf32x3_products([
        dict(x=x, w=w, bias=bias, rowmask=rowmask, scale=0.5, out=cat[:, 4:12]),
        dict(x=x2, w=w2, taps=3, seq=7, out=cat[:, 12:16])])
    assert tf32x3_linear.launches == before
    want = tf32x3_linear_reference(x, w, bias, rowmask=rowmask, scale=0.5)
    assert torch.equal(outs[0], want) and torch.equal(cat[:, 4:12], want)
    assert torch.equal(cat[:, 12:16], tf32x3_linear_reference(x2, w2, taps=3, seq=7))
    assert (cat[:, :4] == 7).all() and (cat[:, 16:] == 7).all()
    assert (cat[rowmask.logical_not(), 4:12] == 0).all()
    torch.testing.assert_close(tf32x3_linear(x, w, bias), F.linear(x, w, bias),
                               rtol=1e-5, atol=1e-5)


def _no_fused_jax(fn):
    prev = jblocks.FUSED_MHCA
    jblocks.FUSED_MHCA = "never"
    try:
        return fn()
    finally:
        jblocks.FUSED_MHCA = prev


@pytest.mark.parametrize("cross,lengths", [(False, [32, 32, 32, 32]),
                                           (True, [32, 20, 9, 0])])
def test_mhca_with_tf32x3_products_matches_pallas(cross, lengths):
    b, tt, c, h = 4, 32, 128, 4
    rng = np.random.default_rng(10)
    x1 = rng.normal(size=(b, tt, c)).astype(np.float32)
    x2 = rng.normal(size=(b, tt, c)).astype(np.float32) if cross else x1
    mask = lengths_mask(b, tt, lengths)
    jmod = jblocks.MaskedMHCA(c, h)
    p = np_tree(jmod.init(jax.random.PRNGKey(0), x1, x2, mask))["params"]
    for name in ("query", "key", "value", "proj"):
        p[name]["bias"] = rng.normal(size=c).astype(np.float32) * 0.1
    kernel = mhca_fused(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask),
                        *pack_mhca_params(p), heads=h, interpret=True)
    port = load_port(MaskedMHCA(c, h), mhca_entries("m", ()), p, "m.")
    with torch.no_grad():
        out = mhca_reference(t(x1), t(x2), t(mask), *port.packed_weights(), heads=h, **TF32)
    close(out, kernel)
    assert (out[np.asarray(lengths) == 0] == 0).all()


@pytest.mark.parametrize("tt,heads,lengths", [(7, 4, [7, 5, 1]), (16, 8, [16, 9, 16])])
def test_csp_with_tf32x3_products_matches_pallas(tt, heads, lengths):
    b, cin, mid, ng, fg = 3, 256, 64, 32, 24
    rng = np.random.default_rng(11)
    x = rng.normal(size=(b, tt, cin)).astype(np.float32)
    g = rng.normal(size=(b, ng, fg)).astype(np.float32)
    mask = lengths_mask(b, tt, lengths)
    jmod = JCSP(in_channels=cin, out_channels=2 * mid, guide_in_features=fg,
                embed_channels=mid, num_heads=heads)
    p = np_tree(_no_fused_jax(lambda: jmod.init(jax.random.PRNGKey(1), x, g, mask,
                                                train=False))["params"])
    p["attn_block"]["bias"] = rng.normal(size=heads).astype(np.float32)
    kernel = csp_fused(jnp.asarray(x), jnp.asarray(g), jnp.asarray(mask),
                       *pack_csp_params(p), attn_heads=heads, interpret=True)
    port = load_port(MaxSigmoidCSPLayer(cin, 2 * mid, fg, mid, heads),
                     csp_entries("c", ()), p, "c.")
    packs = [blk.packed_weights() for blk in port.blocks]
    ab = port.attn_block
    weights = [port.main_conv.conv.weight[:, :, 0], port.main_conv.conv.bias,
               *[torch.stack([pk[i] for pk in packs]) for i in range(5)],
               ab.guide_fc.weight, ab.guide_fc.bias, ab.bias, ab.project_conv.conv.weight,
               ab.project_conv.conv.bias, port.final_conv.conv.weight[:, :, 0],
               port.final_conv.conv.bias]
    with torch.no_grad():
        out = csp_reference(t(x), t(g), t(mask), *weights, attn_heads=heads, **TF32)
        plain = csp_reference(t(x), t(g), t(mask), *weights, attn_heads=heads)
    close(out, kernel)
    close(plain, kernel)
