"""PyTorch port vs the JAX package: the backward of each kernel module on
CPU.

The plain backward (mhca_backward_reference, csp_backward_reference, what
the wrappers run for CPU tensors and what the CUDA backward kernels are held
against on the card) against the vjp of the JAX custom-VJP kernels run in
Pallas interpret mode (their backward is the Pallas backward kernel), and
against jax.vjp of the XLA path. CSP inputs include tied guide tokens, so
the max's grad is split over ties. Tolerances: rtol 1e-4, atol 1e-5."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import unav_yolyolva_tpu.models.blocks as jblocks
from unav_yolyolva_tpu.ops.pallas_csp import csp_fused, csp_reference as jcsp_reference
from unav_yolyolva_tpu.ops.pallas_fusion import mhca_fused_train, pack_mhca_params
from unav_yolyolva_tpu_torch.ops.fused_csp import csp_backward_reference
from unav_yolyolva_tpu_torch.ops.fused_mhca import mhca_backward_reference
from tests._torch_port_common import close, lengths_mask, t
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)


def _mhca_packs(rng, c):
    """Random MHCA weights in the JAX kernel layout: dw (3, 3, C) [which,
    tap, C], lnw/lnb (3, C), dwt (4, C_in, C_out), dbs (4, C)."""
    return (rng.normal(size=(3, 3, c)).astype(np.float32) * 0.5,
            (1 + 0.1 * rng.normal(size=(3, c))).astype(np.float32),
            (0.1 * rng.normal(size=(3, c))).astype(np.float32),
            (rng.normal(size=(4, c, c)) / np.sqrt(c)).astype(np.float32),
            (0.1 * rng.normal(size=(4, c))).astype(np.float32))


def _mhca_to_port(dw, lnw, lnb, dwt, dbs):
    """JAX kernel layout -> the port's: dw (3, C, 3), w (4, out, in). Linear,
    so it maps grads too."""
    return (np.transpose(dw, (0, 2, 1)), lnw, lnb, np.transpose(dwt, (0, 2, 1)), dbs)


@pytest.mark.parametrize("cross,lengths", [(True, [24, 17, 5, 0]), (False, [24, 24, 9, 1])])
def test_mhca_backward_reference_vs_pallas_and_xla(cross, lengths):
    b, tt, c, h = 4, 24, 32, 4
    rng = np.random.default_rng(60)
    x1 = rng.normal(size=(b, tt, c)).astype(np.float32)
    x2 = rng.normal(size=(b, tt, c)).astype(np.float32) if cross else x1
    g = rng.normal(size=(b, tt, c)).astype(np.float32)
    mask = lengths_mask(b, tt, lengths)
    packs = _mhca_packs(rng, c)

    def f(a1, a2, *ws):
        return mhca_fused_train(a1, a2, jnp.asarray(mask), *ws, heads=h, interpret=True)

    _, vjp = jax.vjp(f, jnp.asarray(x1), jnp.asarray(x2), *map(jnp.asarray, packs))
    kern = vjp(jnp.asarray(g))
    port = mhca_backward_reference(t(x1), t(x2), t(mask),
                                   *map(t, _mhca_to_port(*packs)), t(g), heads=h)
    close(port[0], kern[0])
    close(port[1], kern[1])
    for p, k in zip(port[2:], _mhca_to_port(*map(np.asarray, kern[2:]))):
        close(p, k)
    assert (port[0][np.asarray(lengths) == 0] == 0).all()

    # jax.vjp of the XLA module path, its param-tree grads packed like the kernel's
    mod = jblocks.MaskedMHCA(c, h)
    prev, jblocks.FUSED_MHCA = jblocks.FUSED_MHCA, "never"
    try:
        params = mod.init(jax.random.PRNGKey(0), x1, x2, mask, train=True)
        names = {"query": 0, "key": 1, "value": 2, "proj": 3}
        p = jax.tree.map(np.asarray, params)["params"]
        for i, n in enumerate(("query_conv", "key_conv", "value_conv")):
            p[n]["conv"]["kernel"] = packs[0][i][:, None, :]
        for i, n in enumerate(("query_norm", "key_norm", "value_norm")):
            p[n]["weight"], p[n]["bias"] = packs[1][i], packs[2][i]
        for n, i in names.items():
            p[n]["kernel"], p[n]["bias"] = packs[3][i], packs[4][i]
        _, vjp = jax.vjp(lambda pp, a1, a2: mod.apply({"params": pp}, a1, a2, mask,
                                                      train=True)[0], p, x1, x2)
        gp, gx1, gx2 = vjp(jnp.asarray(g))
    finally:
        jblocks.FUSED_MHCA = prev
    if not cross:               # one input feeds both: the port's grads add
        gx1, gx2 = gx1 + gx2, np.zeros_like(gx2)
        port = (port[0] + port[1], torch.zeros_like(port[1])) + tuple(port[2:])
    close(port[0], gx1)
    close(port[1], gx2)
    for pt, xla in zip(port[2:], _mhca_to_port(*map(np.asarray, pack_mhca_params(gp)))):
        close(pt, xla)


def _csp_packs(rng, cin, mid, fg, heads, cout):
    """Random CSP weights in the JAX kernel layout (pack_csp_params)."""
    mh = [_mhca_packs(rng, mid) for _ in range(3)]
    return [(rng.normal(size=(cin, 2 * mid)) / np.sqrt(cin)).astype(np.float32),
            (0.1 * rng.normal(size=(1, 2 * mid))).astype(np.float32),
            *[np.stack([p[i] for p in mh]) for i in range(5)],
            (rng.normal(size=(fg, mid)) / np.sqrt(fg)).astype(np.float32),
            (0.1 * rng.normal(size=(1, mid))).astype(np.float32),
            rng.normal(size=(1, heads)).astype(np.float32),
            (rng.normal(size=(3, mid, mid)) / np.sqrt(3 * mid)).astype(np.float32),
            (0.1 * rng.normal(size=(1, mid))).astype(np.float32),
            (rng.normal(size=(6 * mid, cout)) / np.sqrt(6 * mid)).astype(np.float32),
            (0.1 * rng.normal(size=(1, cout))).astype(np.float32)]


def _csp_to_port(wmain, bmain, dw, lnw, lnb, dwt, dbs, wg, bg, battn, wproj, bproj,
                 wfinal, bfinal):
    """JAX kernel layout -> the port's (torch) layout; linear, maps grads too."""
    return [wmain.T, bmain[0], np.transpose(dw, (0, 1, 3, 2)), lnw, lnb,
            np.transpose(dwt, (0, 1, 3, 2)), dbs, wg.T, bg[0], battn[0],
            np.transpose(wproj, (2, 1, 0)), bproj[0], wfinal.T, bfinal[0]]


@pytest.mark.parametrize("tt,heads,lengths", [(16, 4, [16, 9, 3]), (7, 8, [7, 1, 5])])
def test_csp_backward_reference_vs_pallas_and_reference(tt, heads, lengths):
    b, cin, mid, ng, fg, cout = 3, 64, 32, 16, 24, 64
    rng = np.random.default_rng(61)
    x = rng.normal(size=(b, tt, cin)).astype(np.float32)
    guide = rng.normal(size=(b, ng, fg)).astype(np.float32)
    guide[:, 5] = guide[:, 3] = 3 * rng.normal(size=fg)       # tied maxima
    g = rng.normal(size=(b, tt, cout)).astype(np.float32)
    mask = lengths_mask(b, tt, lengths)
    packs = _csp_packs(rng, cin, mid, fg, heads, cout)
    jpacks = [jnp.asarray(p) for p in packs]

    def kernel(x_, g_, *ws):
        return csp_fused(x_, g_, jnp.asarray(mask), *ws, attn_heads=heads, train=True,
                         interpret=True)

    def xla(x_, g_, *ws):
        return jcsp_reference(x_, g_, jnp.asarray(mask, jnp.float32)[..., None], *ws,
                              attn_heads=heads, mhca_heads=4)

    port = csp_backward_reference(t(x), t(guide), t(mask), *map(t, _csp_to_port(*packs)),
                                  g=t(g), attn_heads=heads)
    for fn in (kernel, xla):
        _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(guide), *jpacks)
        ref = [np.asarray(a) for a in vjp(jnp.asarray(g))]
        close(port[0], ref[0])
        close(port[1], ref[1])
        for p, r in zip(port[2:], _csp_to_port(*ref[2:])):
            close(p, r)
