"""PyTorch port vs the JAX package: the bf16 backward kernels' plain
versions, on the CPU.

Under `tpu.compute_dtype: bfloat16` the JAX Pallas backward kernels run in
bf16: the standalone MHCA's hand-written `_mhca_bwd_kernel`, and the CSP
layer's and the whole TransformerBlock's `jax.vjp` of their bf16 bodies once
per block of rows (`_pick_rows_csp_bwd`, `_pick_rows_tb_bwd`). The port's
plain versions (`mhca_backward_reference`, `csp_backward_reference`,
`tblock_backward_reference` at bf16: what the wrappers run for CPU tensors
and what the CUDA kernels are held against on the card) against those
kernels in Pallas interpret mode, with XLA's `xla_allow_excess_precision`
off (tests/test_torch_port_bf16.py), the same numpy-seeded inputs and
weights:

- every grad tensor in JAX's dtype, norm-wise at most 1/4 of the JAX
  bf16-vs-fp32 gap on the same inputs and at most 2e-2;
- with both row pickers set to one row (the JAX module attribute and the
  port's copy), the port follows the JAX kernel's blocks: its gap to JAX at
  R=1 is below JAX(R=1)'s gap to JAX at its own R, on every weight grad that
  the blocks round;
- the plain XLA-order bf16 sum (ops/bf16_grad.py:xla_sum) against XLA:CPU's
  reduction of the same values, bit for bit.

The whole train step at bf16 is tests/test_torch_port_bf16_step.py."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import unav_yolyolva_tpu.ops.pallas_csp as jcsp
import unav_yolyolva_tpu.ops.pallas_tblock as jtb
from unav_yolyolva_tpu.ops.pallas_csp import csp_fused
from unav_yolyolva_tpu.ops.pallas_fusion import mhca_fused_train
from unav_yolyolva_tpu.ops.pallas_tblock import tblock_fused
import unav_yolyolva_tpu_torch.ops.fused_csp as tcsp
import unav_yolyolva_tpu_torch.ops.fused_tblock as ttb
from unav_yolyolva_tpu_torch.ops.bf16_grad import xla_sum
from unav_yolyolva_tpu_torch.ops.fused_csp import csp_backward_reference
from unav_yolyolva_tpu_torch.ops.fused_mhca import mhca_backward_reference
from unav_yolyolva_tpu_torch.ops.fused_tblock import tblock_backward_reference
from tests._torch_port_common import lengths_mask, t
from tests.test_torch_port_backward import _csp_packs, _csp_to_port, _mhca_packs, _mhca_to_port
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)

BF = jnp.bfloat16
EXACT = {"xla_allow_excess_precision": False}


def _compiled(fn, *args):
    """fn(*args) compiled without XLA's excess precision."""
    return jax.jit(fn).lower(*args).compile(EXACT)(*args)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _bf16(x) -> np.ndarray:
    """x rounded to bf16, as fp32 numpy (the inputs both packages get)."""
    return np.array(jnp.asarray(x).astype(BF).astype(jnp.float32))


def _one_ulp_up(x, rng):
    """x (bf16 values as fp32 numpy) with one value of the first row moved
    to the next bf16 value away from zero: the smallest change the bf16
    program sees."""
    x = x.copy()
    idx = (0,) + tuple(int(rng.integers(0, n)) for n in x.shape[1:])
    v = torch.tensor([x[idx]]).bfloat16()
    x[idx] = (v.view(torch.int16) + 1).view(torch.bfloat16).float().item()
    return x


def _check(name, port, ref, ref32, moved=None):
    """Per grad: JAX's dtype; port-vs-JAX at most 1/4 of JAX's bf16-vs-fp32
    gap and at most 2e-2. Where it is not: the two programs' fp32 sums (a
    LayerNorm's mean, XLA's exp) rounded one bf16 value apart and the flip
    spread through every later bf16 op (one input value moved by one bf16 ulp
    moves JAX's own grads that much; tests/test_torch_port_bf16.py found the
    same in the forward). There the port is held at most 2x JAX's own move
    under such a change (`moved()`: JAX's grads on three such inputs, the
    mean), and at most 2e-2."""
    assert len(port) == len(ref) == len(ref32)
    sens = None
    for i, (p, r, r32) in enumerate(zip(port, ref, ref32)):
        assert str(p.dtype).replace("torch.", "") == str(r.dtype), (name, i, p.dtype, r.dtype)
        gap, ref_gap = _rel(_np(p), _np(r)), _rel(_np(r), _np(r32))
        if gap <= 0.25 * ref_gap and gap <= 2e-2:
            continue
        assert moved is not None, (
            f"{name} grad {i}: port vs JAX bf16 {gap:.3e}, JAX bf16 vs fp32 {ref_gap:.3e}")
        if sens is None:
            runs = moved()
            sens = [[_rel(_np(m[j]), _np(ref[j])) for m in runs] for j in range(len(ref))]
        move = float(np.mean(sens[i]))
        assert gap <= 2 * move and gap <= 2e-2, (
            f"{name} grad {i}: port vs JAX bf16 {gap:.3e}, JAX bf16 vs fp32 {ref_gap:.3e}, "
            f"JAX bf16 moved by one input value one bf16 ulp up {move:.3e}")


@pytest.mark.parametrize("shape,dims", [((2, 224, 16), (0, 1)), ((3, 40, 7, 50), (1, 3)),
                                        ((1000, 16), (0,)), ((2, 4, 100), (2,))])
def test_xla_sum_is_xla_cpus_bf16_reduction(shape, dims):
    rng = np.random.default_rng(90)
    a = jnp.asarray(rng.normal(size=shape), BF)
    ref = _compiled(lambda x: jnp.sum(x, axis=dims, dtype=BF), a)
    got = xla_sum(torch.tensor(np.asarray(a.astype(jnp.float32))).bfloat16(), dims)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("cross", [True, False])
def test_mhca_backward_bf16_vs_pallas(cross):
    """The hand-written backward (pallas_fusion.py:303-486): bf16 dx1, dx2,
    fp32 weight grads."""
    b, tt, c, h = 3, 16, 32, 4
    rng = np.random.default_rng(91)
    x1 = _bf16(rng.normal(size=(b, tt, c)))
    x2 = _bf16(rng.normal(size=(b, tt, c))) if cross else x1
    g = _bf16(rng.normal(size=(b, tt, c)))
    mask = lengths_mask(b, tt, [16, 9, 0])
    packs = _mhca_packs(rng, c)

    def grads(dtype):
        def fn(a1, a2, gg, *ws):
            _, vjp = jax.vjp(lambda u1, u2, *w: mhca_fused_train(
                u1, u2, jnp.asarray(mask), *w, heads=h, interpret=True), a1, a2, *ws)
            return vjp(gg)
        out = _compiled(fn, *[jnp.asarray(a, dtype) for a in (x1, x2, g)],
                        *map(jnp.asarray, packs))
        return [out[0], out[1]] + list(_mhca_to_port(*map(np.asarray, out[2:])))

    ref, ref32 = grads(BF), grads(jnp.float32)
    port = mhca_backward_reference(t(x1).bfloat16(), t(x2).bfloat16(), t(mask),
                                   *map(t, _mhca_to_port(*packs)), t(g).bfloat16(), heads=h)
    _check("mhca", port, ref, ref32)
    assert (port[0][2] == 0).all() and (port[1][2] == 0).all()   # an all-masked row


def _csp_case(tt, heads, lengths):
    b, cin, mid, ng, fg, cout = 3, 64, 32, 16, 24, 64
    rng = np.random.default_rng(92)
    x = _bf16(rng.normal(size=(b, tt, cin)))
    guide = _bf16(rng.normal(size=(b, ng, fg)))
    guide[:, 5] = guide[:, 3] = _bf16(3 * rng.normal(size=fg))       # tied maxima
    g = _bf16(rng.normal(size=(b, tt, cout)))
    return x, guide, g, lengths_mask(b, tt, lengths), _csp_packs(rng, cin, mid, fg, heads, cout)


def _csp_jax(case, heads, dtype, xs=()):
    """JAX's grads on case, and on each x of xs in place of case's."""
    x, guide, g, mask, packs = case

    def fn(x_, g_, gg, *ws):
        _, vjp = jax.vjp(lambda u, v, *w: csp_fused(u, v, jnp.asarray(mask), *w,
                                                    attn_heads=heads, train=True,
                                                    interpret=True), x_, g_, *ws)
        return vjp(gg)

    args = [jnp.asarray(a, dtype) for a in (x, guide, g)] + list(map(jnp.asarray, packs))
    run = jax.jit(fn).lower(*args).compile(EXACT)
    outs = [run(*args)] + [run(jnp.asarray(xm, dtype), *args[1:]) for xm in xs]
    res = [[o[0], o[1]] + [np.asarray(a) for a in _csp_to_port(*map(np.asarray, o[2:]))]
           for o in outs]
    return res if xs else res[0]


def _csp_moved(case, heads):
    rng = np.random.default_rng(94)
    return lambda: _csp_jax(case, heads, BF, [_one_ulp_up(case[0], rng)
                                              for _ in range(3)])[1:]


def _csp_port(case, heads):
    x, guide, g, mask, packs = case
    return csp_backward_reference(t(x).bfloat16(), t(guide).bfloat16(), t(mask),
                                  *map(t, _csp_to_port(*packs)), g=t(g).bfloat16(),
                                  attn_heads=heads)


@pytest.mark.parametrize("tt,heads,lengths", [(16, 4, [16, 9, 3]), (7, 8, [7, 1, 5])])
def test_csp_backward_bf16_vs_pallas(tt, heads, lengths):
    """jax.vjp of the bf16 CSP body per row block (pallas_csp.py:243-281),
    T padded to 8 at T=7, tied guide tokens."""
    case = _csp_case(tt, heads, lengths)
    _check(f"csp T{tt}", _csp_port(case, heads), _csp_jax(case, heads, BF),
           _csp_jax(case, heads, jnp.float32), _csp_moved(case, heads))


def _follows_blocks(name, port1, jax1, jaxb, first_weight):
    """The port at R=1 against JAX at R=1 and JAX at its own R: on each
    weight grad the blocks round (those JAX moves between the two), the
    port's gap below JAX(R=1)'s own gap to JAX(R=b)."""
    moved = 0
    for i in range(first_weight, len(jax1)):
        gap, blocks = _rel(_np(port1[i]), _np(jax1[i])), _rel(_np(jax1[i]), _np(jaxb[i]))
        if blocks > 1e-5:      # a bf16 rounding apart, not the fp32 sums' order
            moved += 1
            assert gap < blocks, f"{name} grad {i}: port {gap:.3e}, JAX R=1 vs R=b {blocks:.3e}"
    assert moved >= 4, f"{name}: the row blocks moved {moved} weight grads"


def test_csp_backward_bf16_follows_the_row_blocks(monkeypatch):
    case = _csp_case(16, 4, [16, 9, 3])
    default = _csp_jax(case, 4, BF)
    monkeypatch.setattr(jcsp, "_pick_rows_csp_bwd", lambda *a, **k: 1)
    monkeypatch.setattr(tcsp, "pick_rows_csp_bwd", lambda *a, **k: 1)
    one = _csp_jax(case, 4, BF)
    _check("csp R=1", _csp_port(case, 4), one, _csp_jax(case, 4, jnp.float32),
           _csp_moved(case, 4))
    _follows_blocks("csp", _csp_port(case, 4), one, default, 2)


def _tb_case():
    import tests.test_torch_port_tblock as tt_

    c, b, tt = 32, 3, 16
    rng = np.random.default_rng(93)
    old = tt_.C, tt_.HID
    tt_.C, tt_.HID = c, 4 * c
    try:
        packs = tt_._jax_packs(rng)
    finally:
        tt_.C, tt_.HID = old
    x = rng.normal(size=(b, tt, c)).astype(np.float32)
    ma = (0.7 + 0.3 * rng.normal(size=(b, 1, c))).astype(np.float32)
    mm = (1.3 + 0.3 * rng.normal(size=(b, 1, c))).astype(np.float32)
    g = rng.normal(size=(b, tt, c)).astype(np.float32)
    return x, lengths_mask(b, tt, [16, 9, 0]), ma, mm, g, packs


def _tb_jax(case, cdtype):
    from tests.test_torch_port_tblock import _to_port

    x, mask, ma, mm, g, packs = case

    def fn(x_, ma_, mm_, gg, *ws):
        _, vjp = jax.vjp(lambda u, a, m, *w: tblock_fused(
            u, jnp.asarray(mask), a, m, *w, heads=4, cdtype=cdtype, train=True,
            interpret=True), x_, ma_, mm_, *ws)
        return vjp(gg)
    out = _compiled(fn, *map(jnp.asarray, (x, ma, mm, g, *packs)))
    return [np.asarray(a) for a in out[:3]] + [np.asarray(a) for a in
                                               _to_port(*map(np.asarray, out[3:]))]


def _tb_port(case):
    from tests.test_torch_port_tblock import _to_port

    x, mask, ma, mm, g, packs = case
    return tblock_backward_reference(t(x), t(mask), t(ma), t(mm), *map(t, _to_port(*packs)),
                                     g=t(g), heads=4, cdtype=torch.bfloat16)


def test_tblock_backward_bf16_vs_pallas(monkeypatch):
    """jax.vjp of the bf16 TBlock body per row block (pallas_tblock.py:
    214-249): fp32 dx and multiplier grads (the residual stream); then with
    one row a block, the port following JAX's blocks."""
    case = _tb_case()
    default = _tb_jax(case, BF)
    _check("tblock", _tb_port(case), default, _tb_jax(case, jnp.float32))
    monkeypatch.setattr(jtb, "_pick_rows_tb_bwd", lambda *a, **k: 1)
    monkeypatch.setattr(ttb, "pick_rows_tb_bwd", lambda *a, **k: 1)
    one = _tb_jax(case, BF)
    port1 = _tb_port(case)
    _check("tblock R=1", port1, one, _tb_jax(case, jnp.float32))
    _follows_blocks("tblock", port1, one, default, 3)
