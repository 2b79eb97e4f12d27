"""Fused MaskedMHCA forward: hand-written CUDA kernel and its plain version.

Replaces the Pallas kernel `_mhca_kernel` (body `_mhca_compute`,
unav_yolyolva_tpu/ops/pallas_fusion.py:50-183): depthwise k=3 convs on q
(from x2) and k/v (from x1), output mask, channel LayerNorm with fp32
statistics, q/k/v dense (q scaled by 1/sqrt(d) after the bias, v masked),
per-head masked softmax attention (masked keys at finfo.min, a row without
a valid key gives exactly 0), proj dense, output mask.

On the card (csrc/mhca.cuh) it is bound by operations: the four C x C
products are ~80% of the FLOPs at the stem shape (64, 224, 512) and the
attention's two products most of the rest. All of them run in 3xTF32 on the
tensor cores (csrc/gemm_tc.cuh, `ops/gemm_tc.py`: fp32-accurate at up to
3x the FFMA rate); the attention tiles 64 queries so that a tile's logits
against all T keys fit in shared memory, which the TPU's whole-(T, T) VMEM
block does not, and streams keys and values through a cp.async ring.

The backward (`mhca_backward`) replaces the Pallas kernel
`_mhca_bwd_kernel` / `_mhca_diff_bwd` (pallas_fusion.py:303-573): it
recomputes the forward from the inputs and weights (nothing else is saved),
keeping its intermediates, and walks the chain in reverse; the attention
backward is split into a query-tiled pass (dq) and a key-tiled pass (dk, dv)
so that neither needs atomics, and every weight grad is a fixed-order sum
over all R*T rows, so two runs give the same bits. Bound: operations, ~2.5x
the forward's (recompute + twice the products), all of which run in 3xTF32
on the tensor cores; the attention backward computes the logits with the
forward's own fragments and order, so P = exp(S - lse) is the forward's P.
On CUDA with grad enabled, `fused_mhca` runs through `MHCAFunction`, whose
backward is that kernel.

Under the bf16 compute policy (bf16 inputs) the same function runs the
JAX package's bf16 program (`_mhca_compute` with bf16 x1, x2): the dwconv
in bf16 with every product and sum rounded, LayerNorm statistics in fp32
stored bf16, each dense layer's fp32 sum rounded to bf16 before its bias
is added in bf16, q scaled by bf16(1/sqrt(d)), fp32 logits and softmax, P
rounded to bf16 before P.V, whose fp32 sum is stored bf16. On the card it
is a kernel of its own (csrc/bf16.cuh, csrc/mhca_bf16.cu): the products
and both attention products on the bf16 tensor cores (mma m16n8k16, fp32
sums), the weights cast to bf16 once per call; the attention keeps a warp's
query rows as tensor-core fragments and takes the softmax in three passes
over its key tiles, with no logits row in shared memory
(`attention_forward` alone). Its backward is the bf16
instantiation of `_mhca_bwd_kernel` (JAX's hand-written backward, op by op:
the recomputed forward in bf16, datt and ds fp32 with ds rounded to bf16
before dq and dk, each input grad rounded to bf16, the weight grads fp32
sums): `_mhca_backward_bf16_reference`, and on the card csrc/bf16_bwd.cuh's
form MHCA_HAND (csrc/mhca_bwd_bf16.cu: every product on the bf16 tensor
cores through one strided product on a cp.async ring, the attention
backward fused into two launches, `attention_backward` alone). It runs for
bf16 inputs on either device: a bf16 call that needs a grad goes through
MHCAFunction on the CPU too.

Weight layout (torch, stacked): dw (3, C, 3) [q/k/v, channel, tap],
lnw/lnb (3, C), w (4, C, C) [q/k/v/proj, out, in], b (4, C).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import cuda_build
from .cuda_build import FLOAT, INT, LONG, PTR
from .bf16_grad import broadcast_mul, fan_out
from .gemm_tc import bf16_product_reference
from .masked import channel_layer_norm
from ..utils.profiling import spanned

_ARGTYPES = {
    "unav_mhca_forward": [PTR, PTR, PTR, INT, INT, INT, INT, PTR, PTR, PTR,
                          PTR, PTR, FLOAT, PTR, PTR, PTR],
}
_BF16_ARGTYPES = {
    "unav_mhca_bf16_forward": [PTR, PTR, PTR, INT, INT, INT, INT, PTR, PTR, PTR, PTR, PTR, FLOAT,
                               PTR, PTR, PTR],
    "unav_attn_bf16": [PTR] * 4 + [INT] * 4 + [PTR, PTR],
    "unav_attn_bf16_blocks_per_sm": [INT] * 3 + [PTR],
}
_BF16_RESTYPES = {"unav_mhca_bf16_scratch": ([INT] * 3, LONG)}
_BWD_ARGTYPES = {
    "unav_mhca_backward": [PTR, PTR, PTR, INT, INT, INT, INT, PTR, PTR, PTR,
                           PTR, PTR, FLOAT] + [PTR] * 10,
}
_BWD_RESTYPES = {"unav_mhca_backward_scratch": ([INT] * 4, LONG)}
_BWD_BF16_ARGTYPES = {"unav_mhca_bf16_backward": [PTR, PTR, PTR, INT, INT, INT, INT, PTR, PTR,
                                                   PTR, PTR, PTR, FLOAT] + [PTR] * 10,
                      "unav_attn_bwd_bf16": [PTR] * 5 + [INT] * 5 + [FLOAT] + [PTR] * 5}
_BWD_BF16_RESTYPES = {"unav_mhca_bf16_backward_scratch": ([INT] * 4, LONG)}

# longest sequence whose logits rows the fp32 attention's 64-query tile and
# the bf16 attention backward's query tile keep in a block's shared memory
# (the bf16 forward stores none, and keeps the same limit)
MAX_T = 512

def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_mask: torch.Tensor, heads: int, *, matmul=torch.matmul) -> torch.Tensor:
    """Per-head masked softmax attention of (B, Tq, C) queries (already
    scaled) over (B, Tk, C) keys/values. Masked keys get finfo.min; a row
    without any valid key outputs 0 instead of NaN. `matmul` computes the
    two products (ops/gemm_tc.py:tf32x3_matmul_reference emulates the
    kernel's). In bf16 the logits and the softmax are fp32 (exact products
    of the bf16 values, fp32 sums), P is rounded to bf16 before P.V, whose
    fp32 sum is stored bf16."""
    b, tq, c = q.shape
    tk = k.shape[1]
    d = c // heads
    dtype = q.dtype
    if dtype != torch.float32:
        q, k, v = q.float(), k.float(), v.float()
    att = matmul(q.reshape(b, tq, heads, d).transpose(1, 2),
                 k.reshape(b, tk, heads, d).permute(0, 2, 3, 1))          # (B, H, Tq, Tk)
    any_kv = kv_mask.any(dim=-1)[:, None, None, None]
    att = att.masked_fill(~kv_mask[:, None, None, :], torch.finfo(att.dtype).min)
    att = torch.where(any_kv, att, torch.zeros((), dtype=att.dtype, device=att.device))
    att = att.softmax(dim=-1) * any_kv.to(att.dtype)
    if dtype != torch.float32:
        att = att.to(dtype).float()
    out = matmul(att, v.reshape(b, tk, heads, d).transpose(1, 2))         # (B, H, Tq, d)
    return out.transpose(1, 2).reshape(b, tq, c).to(dtype)


def mhca_input_uses(x1, x2, lead: int = 0):
    """The nine uses of the inputs by the bf16 MHCA's convs, (centre, right
    tap, left tap) of v, k (from x1) and q (from x2), as aliases whose grads
    add in the order of JAX's backward pass: v's, k's, then q's, after the
    grads of `lead` other uses of x1 (aliases returned ahead of the nine)."""
    if x1 is x2:
        return fan_out(x1, lead + 9)
    return fan_out(x1, lead + 6) + fan_out(x2, 3)


def mhca_reference(x1, x2, mask, dw, lnw, lnb, w, b, *, heads: int,
                   eps: float = 1e-5, linear=F.linear, matmul=torch.matmul,
                   uses=None) -> torch.Tensor:
    """Plain PyTorch version of the fused MHCA (stride 1), in the dtype of
    x1 and x2 (fp32, or bf16 under the bf16 policy). `linear` computes the
    fp32 dense layers and `matmul` the attention's products (the kernel's
    3xTF32 rounding: ops/gemm_tc.py); in bf16 the dense layers are
    `bf16_product_reference` and the products fp32 sums of bf16 values, and
    the inputs' grads add as JAX adds them (`mhca_input_uses`, or the nine
    aliases `uses` of a caller that uses x1 too)."""
    c = x1.shape[-1]
    dtype = x1.dtype
    mm = mask[..., None].to(dtype)
    if dtype != torch.float32:
        linear = bf16_product_reference
        uses = uses or mhca_input_uses(x1, x2)

    def dwconv_ln(x, i):
        if dtype == torch.float32:
            y = F.conv1d(x.transpose(1, 2), dw[i][:, None, :], padding=1,
                         groups=c).transpose(1, 2)
        else:   # the Pallas body's bf16 taps, each product and sum rounded
            xc, xr, xl = uses[3 * (2 - i):3 * (3 - i)]
            wt = dw[i].to(dtype)
            left = F.pad(xl[:, :-1], (0, 0, 1, 0))
            right = F.pad(xr[:, 1:], (0, 0, 0, 1))
            y = (broadcast_mul(left, wt[:, 0]) + broadcast_mul(xc, wt[:, 1])
                 + broadcast_mul(right, wt[:, 2]))
        return channel_layer_norm(y * mm, lnw[i], lnb[i], eps)

    scale = torch.tensor(1.0 / math.sqrt(c // heads), dtype=dtype)
    q = linear(dwconv_ln(x2, 0), w[0], b[0]) * scale
    k = linear(dwconv_ln(x1, 1), w[1], b[1])
    v = linear(dwconv_ln(x1, 2), w[2], b[2]) * mm
    return linear(attend(q, k, v, mask, heads, matmul=matmul), w[3], b[3]) * mm


def mhca_backward_reference(x1, x2, mask, dw, lnw, lnb, w, b, g, *, heads: int,
                            eps: float = 1e-5):
    """Plain version of the backward: (dx1, dx2, gdw, glnw, glnb, gw, gb).
    In fp32 torch.autograd.grad of `mhca_reference` for the upstream grad g;
    for bf16 x1, x2 and g the JAX package's hand-written bf16 backward
    (`_mhca_backward_bf16_reference`)."""
    if x1.dtype == torch.bfloat16:
        return _mhca_backward_bf16_reference(x1, x2, mask, dw, lnw, lnb, w, b, g,
                                             heads=heads, eps=eps)
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x1, x2, dw, lnw, lnb, w, b)]
        out = mhca_reference(ins[0], ins[1], mask, *ins[2:], heads=heads, eps=eps)
        return torch.autograd.grad(out, ins, g)


def _mhca_backward_bf16_reference(x1, x2, mask, dw, lnw, lnb, w, b, g, *, heads: int,
                                  eps: float = 1e-5):
    """The bf16 backward of the JAX package's `_mhca_bwd_kernel`
    (pallas_fusion.py:303-486) op by op: the recomputed forward in bf16 (LN
    statistics and the softmax fp32); g.m times Wp rounded to bf16; per
    head the fp32 softmax, datt = g_o v^T fp32, ds = att (datt - sum(att
    datt)) fp32 rounded to bf16 before dq = ds k and dk = ds^T q, dv = bf16(att)^T
    g_o, each rounded to bf16; dq times bf16(scale), dv masked; each dense
    layer's input grad rounded to bf16, its weight and bias grads fp32 sums;
    the LayerNorm backward fp32, its input grad rounded; the conv's input
    grad in bf16 ((right w0 + dz w1) + left w2, each step rounded), its taps'
    grads fp32 sums. dx1 = dx1(k) + dx1(v) in bf16; weight grads fp32."""
    bf, f32 = torch.bfloat16, torch.float32
    r, t, c = x1.shape
    d = c // heads
    mm = mask[..., None].to(bf)
    dwb, wb, bb = dw.to(bf), w.to(bf).float(), b.to(bf)
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=bf)

    def shl(x):                 # y[t] = x[t-1], zero at t=0
        return F.pad(x[:, :-1], (0, 0, 1, 0))

    def shr(x):                 # y[t] = x[t+1], zero at t=T-1
        return F.pad(x[:, 1:], (0, 0, 0, 1))

    def ln_fwd(z, i):
        zf = z.float()
        res = zf - zf.mean(-1, keepdim=True)
        inv = torch.rsqrt((res * res).mean(-1, keepdim=True) + eps)
        yhat = res * inv
        return (yhat * lnw[i] + lnb[i]).to(bf), yhat, inv

    def project(x, i):          # fp32 sum of bf16 values, rounded, + bf16 bias
        return (x.float() @ wb[i].T).to(bf) + bb[i]

    saved = []
    for i, x in ((0, x2), (1, x1), (2, x1)):
        z = (shl(x) * dwb[i, :, 0] + x * dwb[i, :, 1] + shr(x) * dwb[i, :, 2]) * mm
        y, yhat, inv = ln_fwd(z, i)
        saved.append((y, yhat, inv))
    q = project(saved[0][0], 0) * scale
    k = project(saved[1][0], 1)
    v = project(saved[2][0], 2) * mm

    def heads_of(x):            # (R, T, C) -> (R, H, T, d) fp32
        return x.float().reshape(r, t, heads, d).transpose(1, 2)

    def cat(x):                 # (R, H, T, d) -> (R, T, C)
        return x.transpose(1, 2).reshape(r, t, c)

    gp = g * mm
    g_o = (gp.float() @ wb[3]).to(bf)
    qh, kh, vh, goh = heads_of(q), heads_of(k), heads_of(v), heads_of(g_o)
    logits = (qh @ kh.transpose(-1, -2)).masked_fill(~mask[:, None, None, :],
                                                     torch.finfo(f32).min)
    any_kv = mask.any(-1)[:, None, None, None]
    logits = torch.where(any_kv, logits, torch.zeros((), dtype=f32))
    att = logits.softmax(-1) * any_kv.to(f32)
    att_c = att.to(bf).float()
    o_cat = cat((att_c @ vh).to(bf))
    datt = goh @ vh.transpose(-1, -2)
    ds = (att * (datt - (att * datt).sum(-1, keepdim=True))).to(bf).float()
    dq = cat((ds @ kh).to(bf)) * scale
    dk = cat((ds.transpose(-1, -2) @ qh).to(bf))
    dv = cat((att_c.transpose(-1, -2) @ goh).to(bf)) * mm

    gdw, glnw, glnb, gw, gb, dxs = [], [], [], [], [], []
    for i, (dy, x_src) in enumerate(((dq, x2), (dk, x1), (dv, x1))):
        y, yhat, inv = saved[i]
        dyf = dy.float()
        gw.append(dyf.reshape(-1, c).T @ y.float().reshape(-1, c))
        gb.append(dyf.sum((0, 1)))
        dyl = (dyf @ wb[i]).to(bf).float()                  # the LN output's grad
        glnw.append((dyl * yhat).sum((0, 1)))
        glnb.append(dyl.sum((0, 1)))
        dyhat = dyl * lnw[i]
        dz = inv * (dyhat - dyhat.mean(-1, keepdim=True)
                    - yhat * (dyhat * yhat).mean(-1, keepdim=True))
        dzm = dz.to(bf) * mm
        dxs.append(shr(dzm) * dwb[i, :, 0] + dzm * dwb[i, :, 1] + shl(dzm) * dwb[i, :, 2])
        xf, dzf = x_src.float(), dzm.float()
        gdw.append(torch.stack([(shl(xf) * dzf).sum((0, 1)), (xf * dzf).sum((0, 1)),
                                (shr(xf) * dzf).sum((0, 1))], -1))
    gpf = gp.float()
    gw.append(gpf.reshape(-1, c).T @ o_cat.float().reshape(-1, c))
    gb.append(gpf.sum((0, 1)))
    return (dxs[1] + dxs[2], dxs[0], torch.stack(gdw), torch.stack(glnw), torch.stack(glnb),
            torch.stack(gw), torch.stack(gb))


def attention_forward(q, k, v, mask, *, heads: int) -> torch.Tensor:
    """The bf16 MHCA forward's attention kernel alone (one launch): q (scaled
    by bf16(1/sqrt(d))), k and v (R, T, C) bf16 over the (R, T) key mask, as
    `attend` computes it in bf16 (its plain version). CPU tensors take
    `attend`; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return attend(q, k, v, mask, heads)
    r, t, c = q.shape
    if c % heads or (c // heads) % 8 or c // heads > 128 or t > MAX_T:
        raise ValueError(f"attention_forward: unsupported shape (T={t}, C={c}, heads={heads})")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(x, name, q.shape, torch.bfloat16)
    _check(mask, "mask", (r, t), torch.bool)
    out = torch.empty_like(q)
    lib = cuda_build.library("mhca_bf16", _BF16_ARGTYPES, _BF16_RESTYPES)
    rc = lib.unav_attn_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), r, t, c,
                            heads, out.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(lib, rc, "attention_forward (bf16)")
    attention_forward.launches += 1
    return out


attention_forward.launches = 0


def attention_blocks_per_sm(t: int, c: int, heads: int) -> int:
    """Resident blocks a SM of the bf16 attention kernel at sequence length
    t and width c over `heads` heads (CUDA's occupancy calculator)."""
    lib = cuda_build.library("mhca_bf16", _BF16_ARGTYPES, _BF16_RESTYPES)
    blocks = ctypes.c_int(0)
    cuda_build.check(lib, lib.unav_attn_bf16_blocks_per_sm(t, c, heads, ctypes.byref(blocks)),
                     "attention_blocks_per_sm")
    return blocks.value


def attention_backward_reference(q, k, v, go, mask, *, heads: int, vjp: bool = False,
                                 rounded: bool = True):
    """The attention part of the bf16 MHCA backward (csrc/bf16_bwd.cuh's fused
    attention backward) in plain PyTorch, for q (scaled by bf16(1/sqrt(d))),
    k, v and the attention output's grad go (R, T, C) bf16 with a (R, T) key
    mask: the fp32 logits and softmax (a sequence without a valid key gets
    P = 0), datt = go v^T in fp32 (rounded to bf16 in the vjp form), ds = P
    (datt - sum(P datt)) in fp32 (rounded to bf16 in the hand form), dq =
    bf16(bf16(ds k) * scale), dk = bf16(ds^T q), dv = bf16(bf16(P)^T go) *
    mask. rounded=False takes the same steps in fp32 with no bf16 rounding.
    Returns (dq, dk, dv), bf16 (fp32 unrounded)."""
    f32 = torch.float32
    r, t, c = q.shape
    d = c // heads
    scale = float(torch.tensor(1.0 / math.sqrt(d), dtype=torch.bfloat16))

    def rnd(x):
        return x.to(torch.bfloat16).float() if rounded else x

    def heads_of(x):            # (R, T, C) -> (R, H, T, d) fp32
        return x.float().reshape(r, t, heads, d).transpose(1, 2)

    def cat(x):                 # (R, H, T, d) -> (R, T, C)
        return x.transpose(1, 2).reshape(r, t, c)

    qh, kh, vh, gh = (heads_of(x) for x in (q, k, v, go))
    logits = (qh @ kh.transpose(-1, -2)).masked_fill(~mask[:, None, None, :],
                                                     torch.finfo(f32).min)
    any_kv = mask.any(-1)[:, None, None, None]
    att = torch.where(any_kv, logits, torch.zeros((), dtype=f32)).softmax(-1) * any_kv.to(f32)
    datt = gh @ vh.transpose(-1, -2)
    if vjp:
        datt = rnd(datt)
    ds = att * (datt - (att * datt).sum(-1, keepdim=True))
    if not vjp:
        ds = rnd(ds)
    out = (cat(rnd(rnd(ds @ kh) * scale)), cat(rnd(ds.transpose(-1, -2) @ qh)),
           cat(rnd(rnd(att).transpose(-1, -2) @ gh)) * mask[..., None].to(f32))
    return tuple(x.to(torch.bfloat16) for x in out) if rounded else out


def attention_backward(q, k, v, go, mask, *, heads: int, vjp: bool = False):
    """The fused bf16 attention backward alone (two launches), as
    `attention_backward_reference` describes it: (dq, dk, dv) bf16. CPU
    tensors take that plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return attention_backward_reference(q, k, v, go, mask, heads=heads, vjp=vjp)
    r, t, c = q.shape
    if c % heads or (c // heads) % 8 or c // heads > 128 or t > MAX_T:
        raise ValueError(f"attention_backward: unsupported shape (T={t}, C={c}, heads={heads})")
    for name, x in (("q", q), ("k", k), ("v", v), ("go", go)):
        _check(x, name, q.shape, torch.bfloat16)
    _check(mask, "mask", (r, t), torch.bool)
    out = [torch.empty_like(q) for _ in range(3)]
    stat = torch.empty(r * heads * t * 3, device=q.device, dtype=torch.float32)
    lib = cuda_build.library("mhca_bwd_bf16", _BWD_BF16_ARGTYPES, _BWD_BF16_RESTYPES)
    rc = lib.unav_attn_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), go.data_ptr(), mask.data_ptr(), r, t, c,
        heads, int(vjp), float(torch.tensor(1.0 / math.sqrt(c // heads), dtype=torch.bfloat16)),
        *[x.data_ptr() for x in out], stat.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(lib, rc, "attention_backward (bf16)")
    attention_backward.launches += 1
    return tuple(out)


attention_backward.launches = 0


def _check(t: torch.Tensor, name: str, shape=None, dtype=torch.float32):
    # operands 16-byte aligned: the tensor-core products and the attention
    # copy rows in 16-byte chunks
    if (t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous()
            or (dtype != torch.bool and t.data_ptr() % 16)):
        raise ValueError(f"{name}: needs a contiguous, 16-byte aligned {dtype} CUDA tensor, "
                         f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()}, "
                         f"address {t.data_ptr():#x})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def _check_args(x1, x2, mask, dw, lnw, lnb, w, b, heads):
    r, t, c = x1.shape
    # head widths of whole 16-byte chunks (4 floats, 8 bf16): rows and heads
    # start on 16 bytes
    per_chunk = 16 // x1.element_size()
    if (c % heads or (c // heads) % per_chunk or c // heads > 128 or c > 1024
            or t > MAX_T):
        raise ValueError(f"fused_mhca: unsupported shape (T={t}, C={c}, heads={heads}, "
                         f"{x1.dtype})")
    if x1.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_mhca: {x1.dtype} inputs; the kernels take fp32 or bf16")
    _check(x1, "x1", dtype=x1.dtype)
    _check(x2, "x2", x1.shape, x1.dtype)
    _check(mask, "mask", (r, t), torch.bool)
    _check(dw, "dw", (3, c, 3))
    _check(lnw, "lnw", (3, c))
    _check(lnb, "lnb", (3, c))
    _check(w, "w", (4, c, c))
    _check(b, "b", (4, c))


def _forward_kernel_bf16(x1, x2, mask, dw, lnw, lnb, w, b, heads, eps):
    r, t, c = x1.shape
    out = torch.empty_like(x1)
    lib = cuda_build.library("mhca_bf16", _BF16_ARGTYPES, _BF16_RESTYPES)
    scratch = torch.empty(lib.unav_mhca_bf16_scratch(r, t, c), device=x1.device,
                          dtype=torch.bfloat16)
    rc = lib.unav_mhca_bf16_forward(
        x1.data_ptr(), x2.data_ptr(), mask.data_ptr(), r, t, c, heads,
        dw.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), w.data_ptr(), b.data_ptr(),
        eps, out.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(x1.device).cuda_stream,
    )
    cuda_build.check(lib, rc, "fused_mhca (bf16)")
    fused_mhca.bf16_launches += 1
    return out


def _forward_kernel(x1, x2, mask, dw, lnw, lnb, w, b, heads, eps):
    _check_args(x1, x2, mask, dw, lnw, lnb, w, b, heads)
    if x1.dtype == torch.bfloat16:
        return _forward_kernel_bf16(x1, x2, mask, dw, lnw, lnb, w, b, heads, eps)
    r, t, c = x1.shape
    out = torch.empty_like(x1)
    scratch = torch.empty(6 * r * t * c, device=x1.device, dtype=torch.float32)
    lib = cuda_build.library("mhca", _ARGTYPES)
    rc = lib.unav_mhca_forward(
        x1.data_ptr(), x2.data_ptr(), mask.data_ptr(), r, t, c, heads,
        dw.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), w.data_ptr(), b.data_ptr(),
        eps, out.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(x1.device).cuda_stream,
    )
    cuda_build.check(lib, rc, "fused_mhca")
    fused_mhca.launches += 1
    return out


def _backward_kernel_bf16(x1, x2, mask, dw, lnw, lnb, w, b, g, grads, heads, eps):
    r, t, c = x1.shape
    lib = cuda_build.library("mhca_bwd_bf16", _BWD_BF16_ARGTYPES, _BWD_BF16_RESTYPES)
    scratch = torch.empty(lib.unav_mhca_bf16_backward_scratch(r, t, c, heads),
                          device=x1.device, dtype=torch.float32)
    rc = lib.unav_mhca_bf16_backward(
        x1.data_ptr(), x2.data_ptr(), mask.data_ptr(), r, t, c, heads,
        dw.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), w.data_ptr(), b.data_ptr(),
        eps, g.data_ptr(), *[x.data_ptr() for x in grads], scratch.data_ptr(),
        torch.cuda.current_stream(x1.device).cuda_stream,
    )
    cuda_build.check(lib, rc, "mhca_backward (bf16)")
    return tuple(grads)


@spanned("unav.kernel.mhca_backward")
def mhca_backward(x1, x2, mask, dw, lnw, lnb, w, b, g, *, heads: int,
                  eps: float = 1e-5):
    """Grads of the MaskedMHCA forward for the upstream grad g (R, T, C):
    (dx1, dx2, gdw, glnw, glnb, gw, gb), in the layouts of the inputs. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if x1.device.type == "cpu":
        return mhca_backward_reference(x1, x2, mask, dw, lnw, lnb, w, b, g,
                                       heads=heads, eps=eps)
    _check_args(x1, x2, mask, dw, lnw, lnb, w, b, heads)
    _check(g, "g", x1.shape, x1.dtype)
    r, t, c = x1.shape
    grads = [torch.empty_like(x) for x in (x1, x2, dw, lnw, lnb, w, b)]
    if x1.dtype == torch.bfloat16:
        out = _backward_kernel_bf16(x1, x2, mask, dw, lnw, lnb, w, b, g, grads, heads, eps)
        mhca_backward.bf16_launches += 1
        return out
    lib = cuda_build.library("mhca_bwd", _BWD_ARGTYPES, _BWD_RESTYPES)
    scratch = torch.empty(lib.unav_mhca_backward_scratch(r, t, c, heads),
                          device=x1.device, dtype=torch.float32)
    rc = lib.unav_mhca_backward(
        x1.data_ptr(), x2.data_ptr(), mask.data_ptr(), r, t, c, heads,
        dw.data_ptr(), lnw.data_ptr(), lnb.data_ptr(), w.data_ptr(), b.data_ptr(),
        eps, g.data_ptr(), *[x.data_ptr() for x in grads], scratch.data_ptr(),
        torch.cuda.current_stream(x1.device).cuda_stream,
    )
    cuda_build.check(lib, rc, "mhca_backward")
    mhca_backward.launches += 1
    return tuple(grads)


class MHCAFunction(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient. Like the
    JAX custom_vjp it saves only the inputs and weights; the mask gets no
    grad."""

    @staticmethod
    def forward(ctx, x1, x2, mask, dw, lnw, lnb, w, b, heads, eps):
        ctx.save_for_backward(x1, x2, mask, dw, lnw, lnb, w, b)
        ctx.heads, ctx.eps = heads, eps
        if x1.device.type == "cpu":
            return mhca_reference(x1, x2, mask, dw, lnw, lnb, w, b, heads=heads, eps=eps)
        return _forward_kernel(x1, x2, mask, dw, lnw, lnb, w, b, heads, eps)

    @staticmethod
    def backward(ctx, g):
        x1, x2, mask, *ws = ctx.saved_tensors
        dx1, dx2, *gws = mhca_backward(x1, x2, mask, *ws, g.contiguous(),
                                       heads=ctx.heads, eps=ctx.eps)
        return (dx1, dx2, None, *gws, None, None)


@spanned("unav.kernel.mhca")
def fused_mhca(x1, x2, mask, dw, lnw, lnb, w, b, *, heads: int,
               eps: float = 1e-5) -> torch.Tensor:
    """MaskedMHCA forward of (R, T, C) inputs (fp32, or bf16 under the bf16
    policy; weights fp32) with a (R, T) bool mask, in the inputs' dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel of
    their dtype. When a grad is needed the call goes through MHCAFunction,
    whose backward is the backward kernel of the dtype (on the CPU its plain
    version), but for fp32 CPU tensors, where autograd differentiates the
    plain forward (the same function in fp32)."""
    args = (x1, x2, mask, dw, lnw, lnb, w, b)
    grad = torch.is_grad_enabled() and any(a.requires_grad for a in args)
    if x1.device.type == "cpu" and not (grad and x1.dtype == torch.bfloat16):
        return mhca_reference(x1, x2, mask, dw, lnw, lnb, w, b, heads=heads, eps=eps)
    if grad:
        return MHCAFunction.apply(*args, heads, eps)
    return _forward_kernel(*args, heads, eps)


fused_mhca.launches = 0
fused_mhca.bf16_launches = 0
mhca_backward.launches = 0
mhca_backward.bf16_launches = 0
