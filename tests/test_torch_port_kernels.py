"""PyTorch port vs the JAX package: the three kernel modules on CPU.

On the CPU each wrapper takes its plain PyTorch version, which must agree
with the Pallas kernel run in interpret mode and with the JAX package's XLA
path: fused MHCA, fused CSP layer (T = 7 and 16, 4 and 8 heads) and the
merged class-masked Soft-NMS scan (random sets with several classes, tied
scores, -inf lanes and an empty row). Tolerances: rtol 1e-4, atol 1e-5."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import unav_yolyolva_tpu.models.blocks as jblocks
from unav_yolyolva_tpu.models.fusion import MaxSigmoidCSPLayer as JCSP
from unav_yolyolva_tpu.ops import nms as jnms
from unav_yolyolva_tpu.ops.pallas_csp import csp_fused, csp_reference, pack_csp_params
from unav_yolyolva_tpu.ops.pallas_fusion import mhca_fused, pack_mhca_params
from unav_yolyolva_tpu.ops.pallas_nms import multiclass_soft_nms_pallas
from unav_yolyolva_tpu_torch.models.blocks import MaskedMHCA
from unav_yolyolva_tpu_torch.models.fusion import MaxSigmoidCSPLayer
from unav_yolyolva_tpu_torch.ops import nms as tnms
from unav_yolyolva_tpu_torch.ops.fused_mhca import fused_mhca
from unav_yolyolva_tpu_torch.ops.fused_nms import multiclass_soft_nms
from unav_yolyolva_tpu_torch.utils.convert import csp_entries, mhca_entries
from tests._torch_port_common import close, lengths_mask, load_port, np_tree, t
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)


def _xla(module, params, *args, **kw):
    prev = jblocks.FUSED_MHCA
    jblocks.FUSED_MHCA = "never"
    try:
        return module.apply(params, *args, **kw)
    finally:
        jblocks.FUSED_MHCA = prev


@pytest.mark.parametrize("cross,lengths", [(False, [32, 32, 32, 32]),
                                           (True, [32, 20, 9, 0])])
def test_fused_mhca_plain_vs_pallas_and_xla(cross, lengths):
    b, tt, c, h = 4, 32, 128, 4
    rng = np.random.default_rng(10)
    x1 = rng.normal(size=(b, tt, c)).astype(np.float32)
    x2 = rng.normal(size=(b, tt, c)).astype(np.float32) if cross else x1
    mask = lengths_mask(b, tt, lengths)
    jmod = jblocks.MaskedMHCA(c, h)
    p = np_tree(jmod.init(jax.random.PRNGKey(0), x1, x2, mask))["params"]
    # non-zero biases exercise the epilogues
    for name in ("query", "key", "value", "proj"):
        p[name]["bias"] = rng.normal(size=c).astype(np.float32) * 0.1
    kernel = mhca_fused(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask),
                        *pack_mhca_params(p), heads=h, interpret=True)
    xla, _ = _xla(jmod, {"params": p}, x1, x2, mask)
    port = load_port(MaskedMHCA(c, h), mhca_entries("m", ()), p, "m.")
    with torch.no_grad():
        out = fused_mhca(t(x1), t(x2), t(mask), *port.packed_weights(), heads=h)
    close(out, kernel)
    close(out, xla)
    assert (out[np.asarray(lengths) == 0] == 0).all()


@pytest.mark.parametrize("tt,heads,lengths", [(7, 4, [7, 5, 1]), (16, 8, [16, 9, 16]),
                                              (16, 4, [16, 3, 11])])
def test_fused_csp_plain_vs_pallas_and_reference(tt, heads, lengths):
    b, cin, mid, ng, fg = 3, 256, 64, 32, 24
    rng = np.random.default_rng(11)
    x = rng.normal(size=(b, tt, cin)).astype(np.float32)
    g = rng.normal(size=(b, ng, fg)).astype(np.float32)
    mask = lengths_mask(b, tt, lengths)
    jmod = JCSP(in_channels=cin, out_channels=2 * mid, guide_in_features=fg,
                embed_channels=mid, num_heads=heads)
    prev = jblocks.FUSED_MHCA
    jblocks.FUSED_MHCA = "never"
    try:
        p = np_tree(jmod.init(jax.random.PRNGKey(1), x, g, mask, train=False))["params"]
    finally:
        jblocks.FUSED_MHCA = prev
    p["attn_block"]["bias"] = rng.normal(size=heads).astype(np.float32)
    packs = pack_csp_params(p)
    kernel = csp_fused(jnp.asarray(x), jnp.asarray(g), jnp.asarray(mask), *packs,
                       attn_heads=heads, interpret=True)
    ref = csp_reference(jnp.asarray(x), jnp.asarray(g),
                        jnp.asarray(mask, jnp.float32)[..., None], *packs,
                        attn_heads=heads, mhca_heads=4)
    xla, _ = _xla(jmod, {"params": p}, x, g, mask, train=False)
    port = load_port(MaxSigmoidCSPLayer(cin, 2 * mid, fg, mid, heads),
                     csp_entries("c", ()), p, "c.")
    with torch.no_grad():
        out, _ = port(t(x), t(g), t(mask))
    close(out, kernel)
    close(out, ref)
    close(out, xla)


def _nms_inputs(seed, g=4, n=300, ncls=5):
    rng = np.random.default_rng(seed)
    start = rng.uniform(0, 50, size=(g, n)).astype(np.float32)
    segs = np.stack([start, start + rng.uniform(0.5, 12, size=(g, n))], -1).astype(np.float32)
    scores = rng.uniform(0.001, 1.0, size=(g, n)).astype(np.float32)
    scores[:, 10:20] = scores[:, 0:1]                      # tied scores
    scores[rng.uniform(size=(g, n)) < 0.2] = -np.inf       # dead lanes
    scores[g - 1] = -np.inf                                # an empty row
    cls = rng.integers(0, ncls, size=(g, n)).astype(np.int32)
    return segs, scores, cls


def _unambiguous(sc_p, sc_r):
    """Emitted scores agree within rtol 1e-5; returns the slots whose score
    is more than 1e-6 from its neighbours' (elsewhere a tie may swap the
    order of two emissions)."""
    np.testing.assert_allclose(sc_p, sc_r, rtol=1e-5, atol=1e-7)
    gap = np.full(sc_r.shape, np.inf)
    d = np.abs(np.diff(sc_r, axis=1))
    gap[:, 1:] = np.minimum(gap[:, 1:], d)
    gap[:, :-1] = np.minimum(gap[:, :-1], d)
    return gap > 1e-6


@pytest.mark.parametrize("seed,sigma,min_score", [(0, 0.4, 0.001), (1, 0.5, 0.05)])
def test_multiclass_soft_nms_plain_vs_pallas(seed, sigma, min_score):
    segs, scores, cls = _nms_inputs(seed)
    kw = dict(max_out=50, sigma=sigma, min_score=min_score)
    ri, rs, rv = multiclass_soft_nms_pallas(jnp.asarray(segs), jnp.asarray(scores),
                                            jnp.asarray(cls), iou_threshold=0.7,
                                            interpret=True, **kw)
    pi, ps, pv = multiclass_soft_nms(t(segs), t(scores), t(cls), **kw)
    sure = _unambiguous(ps.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(pi.numpy()[sure], np.asarray(ri)[sure])
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    assert (pi[-1] == -1).all() and (ps[-1] == 0).all()


def test_multiclass_nms_batch():
    segs, scores, cls = _nms_inputs(2, g=3, n=200)
    valid = np.isfinite(scores)
    scores = np.where(valid, scores, 0.5).astype(np.float32)
    kw = dict(max_seg_num=250, sigma=0.4, min_score=0.001)
    ref = jnms.multiclass_nms_batch(jnp.asarray(segs), jnp.asarray(scores),
                                    jnp.asarray(cls), jnp.asarray(valid),
                                    iou_threshold=0.7, **kw)
    out = tnms.multiclass_nms_batch(t(segs), t(scores), t(cls), t(valid), **kw)
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    sure = _unambiguous(out[1].numpy(), np.asarray(ref[1])) & np.asarray(ref[3])
    np.testing.assert_array_equal(out[0].numpy()[sure], np.asarray(ref[0])[sure])
    np.testing.assert_array_equal(out[2].numpy()[sure], np.asarray(ref[2])[sure])
