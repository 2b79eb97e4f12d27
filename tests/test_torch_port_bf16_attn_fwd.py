"""The bf16 forward's attention and CSP gate alone: the port's plain
versions (what `attention_forward` and the CSP layer run on CPU tensors)
against the JAX package's bf16 body, on the CPU.

- The attention (`ops/fused_mhca.py:attention_forward` on CPU tensors: its
  plain version, the bf16 branch of `attend`) against the per-head
  attention of the JAX `_mhca_compute` in bf16
  (unav_yolyolva_tpu/ops/pallas_fusion.py:93-106: fp32 logits of the bf16 q
  and k, masked keys at finfo.min, a row without a valid key 0, fp32
  softmax, P cast to bf16, P.V summed in fp32 and cast to bf16), at small
  shapes with ragged lengths and a sequence without a valid key. Same
  dtype; norm-wise gap at most 1/4 of the JAX bf16-vs-fp32 gap on the same
  inputs and at most 2e-2 (the two sum the logits and the softmax in
  another order, so a P may round to the neighbouring bf16 value); the
  empty sequence exactly 0 on both sides.
- The max-sigmoid gate (`ops/fused_csp.py:gate_reference`, the plain
  version inside `csp_reference`) against the JAX body's gate
  (pallas_csp.py:118-127) with a guide token planted twice, in two
  64-token tiles of the card's scoring, so that the max ties: the gated
  values by the same criterion, the scores of the two tied tokens equal,
  and, in fp32, the grad of the output's sum with respect to gp (JAX's max
  splits it evenly over the ties, as torch.amax does) within 1e-5 norm-wise
  (another summation order) and equal on the two tied tokens.

The JAX programs are compiled with `xla_allow_excess_precision` off, so that
every bf16 op rounds as written (tests/test_torch_port_bf16.py)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unav_yolyolva_tpu_torch.ops.fused_csp import gate_reference
from unav_yolyolva_tpu_torch.ops.fused_mhca import attend, attention_forward
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)

BF = jnp.bfloat16
EXACT = {"xla_allow_excess_precision": False}


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(EXACT)(*args)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _gap_ok(name, port, jax_bf16, jax_f32):
    gap, ref_gap = _rel(_np(port), _np(jax_bf16)), _rel(_np(jax_bf16), _np(jax_f32))
    assert gap <= 0.25 * ref_gap and gap <= 2e-2, (
        f"{name}: port vs JAX bf16 {gap:.3e}, JAX bf16 vs fp32 {ref_gap:.3e}")


def _jax_attention(q, k, v, mm, heads):
    """pallas_fusion.py:93-106, the attention of `_mhca_compute`, on q
    (already scaled), k, v (R, T, C) in their dtype and mm (R, T, 1)."""
    dtype = q.dtype
    d = q.shape[-1] // heads
    neg_inf = jnp.finfo(jnp.float32).min
    key_ok = jnp.transpose(mm.astype(jnp.float32), (0, 2, 1)) > 0.0
    any_kv = jnp.max(mm.astype(jnp.float32), axis=1, keepdims=True) > 0.0
    outs = []
    for h_i in range(heads):
        sl = slice(h_i * d, (h_i + 1) * d)
        att = jnp.einsum("rtd,rsd->rts", q[:, :, sl], k[:, :, sl],
                         preferred_element_type=jnp.float32)
        att = jnp.where(key_ok, att, neg_inf)
        att = jnp.where(any_kv, att, 0.0)
        att = jax.nn.softmax(att, axis=-1)
        att = att * any_kv.astype(att.dtype)
        outs.append(jnp.einsum("rts,rsd->rtd", att.astype(dtype), v[:, :, sl],
                               preferred_element_type=jnp.float32).astype(dtype))
    return jnp.concatenate(outs, axis=-1)


@pytest.mark.parametrize("t,c,heads,lengths", [(16, 32, 4, [16, 9, 0]),
                                               (7, 64, 2, [7, 1, 0]),
                                               (33, 48, 3, [33, 20, 0]),
                                               (20, 128, 1, [0, 13, 20])])
def test_attention_forward_plain_vs_jax_bf16(t, c, heads, lengths):
    rng = np.random.default_rng(90 + t)
    r, d = len(lengths), c // heads
    q = (rng.normal(size=(r, t, c)) * d ** -0.5).astype(np.float32)
    k, v = (rng.normal(size=(r, t, c)).astype(np.float32) for _ in range(2))
    mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    mm = jnp.asarray(mask[..., None].astype(np.float32))
    qb, kb, vb = (jnp.asarray(x).astype(BF) for x in (q, k, v))
    ref = _compiled(lambda a, b, e: _jax_attention(a, b, e, mm.astype(BF), heads), qb, kb, vb)
    ref32 = _compiled(lambda a, b, e: _jax_attention(a, b, e, mm, heads),
                      *(x.astype(jnp.float32) for x in (qb, kb, vb)))
    qt, kt, vt = (torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
                  for x in (qb, kb, vb))
    out = attention_forward(qt, kt, vt, torch.from_numpy(mask), heads=heads)
    assert out.dtype == torch.bfloat16 and ref.dtype == BF
    assert torch.equal(out, attend(qt, kt, vt, torch.from_numpy(mask), heads))
    _gap_ok(f"attention T{t} d{d}", out, ref, ref32)
    for i, n in enumerate(lengths):
        if n == 0:
            assert (out[i] == 0).all() and (np.asarray(ref[i], np.float32) == 0).all()


def _jax_gate(p, gp, pc, battn, heads):
    """pallas_csp.py:118-127: the gated projection of `_csp_compute`."""
    dtype = p.dtype
    hc = gp.shape[-1] // heads
    och = pc.shape[-1] // heads
    gated = []
    for h in range(heads):
        sc = jnp.einsum("rtc,rnc->rtn", p[:, :, h * hc:(h + 1) * hc], gp[:, :, h * hc:(h + 1) * hc],
                        preferred_element_type=jnp.float32)
        mx = jnp.max(sc, axis=-1, keepdims=True) / math.sqrt(hc)
        gate = jax.nn.sigmoid(mx + battn[h]).astype(dtype)
        gated.append(pc[:, :, h * och:(h + 1) * och] * gate)
    return jnp.concatenate(gated, axis=-1)


@pytest.mark.parametrize("heads", [4, 8])
def test_plain_gate_vs_jax_bf16_with_a_tie(heads):
    r, t, mid, ng = 3, 9, 64, 150
    rng = np.random.default_rng(95 + heads)
    gp = rng.normal(size=(r, ng, mid)).astype(np.float32)
    gp[:, 3] *= 2
    gp[:, 140] = gp[:, 3]           # tokens 3 and 140: two 64-token tiles apart,
    p = (0.3 * rng.normal(size=(r, t, mid)) + gp[:, 3:4]).astype(np.float32)   # the max
    pc = rng.normal(size=(r, t, mid)).astype(np.float32)
    battn = rng.normal(size=heads).astype(np.float32)
    pb, gb, cb = (jnp.asarray(x).astype(BF) for x in (p, gp, pc))
    jb = jnp.asarray(battn)
    ref = _compiled(lambda a, b, e: _jax_gate(a, b, e, jb, heads), pb, gb, cb)
    ref32 = _compiled(lambda a, b, e: _jax_gate(a, b, e, jb, heads),
                      *(x.astype(jnp.float32) for x in (pb, gb, cb)))
    pt, gt, ct = (torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
                  for x in (pb, gb, cb))
    out = gate_reference(pt, gt, ct, torch.from_numpy(battn), attn_heads=heads)
    assert out.dtype == torch.bfloat16 and ref.dtype == BF
    _gap_ok(f"gate {heads} heads", out, ref, ref32)

    hc = mid // heads
    sc = torch.einsum("rthc,rnhc->rhtn", pt.float().reshape(r, t, heads, hc),
                      gt.float().reshape(r, ng, heads, hc))
    assert torch.equal(sc[..., 3], sc[..., 140])
    top = sc.argmax(-1)
    assert ((top == 3) | (top == 140)).float().mean() > 0.5   # the tie is the max

    # the grad of the output's sum through the max (fp32 program): split over
    # the tie evenly on both sides
    g32 = gt.float().requires_grad_(True)
    out32 = gate_reference(pt.float(), g32, ct.float(), torch.from_numpy(battn),
                           attn_heads=heads)
    (dgp,) = torch.autograd.grad(out32.sum(), g32)
    jgrad = np.asarray(jax.grad(lambda b: _jax_gate(pb.astype(jnp.float32), b,
                                                    cb.astype(jnp.float32), jb,
                                                    heads).sum())(gb.astype(jnp.float32)))
    assert torch.equal(dgp[:, 3], dgp[:, 140]) and (jgrad[:, 3] == jgrad[:, 140]).all()
    assert (dgp[:, 3].abs().sum(-1) > 0).all()
    assert _rel(dgp.numpy(), jgrad) <= 1e-5
