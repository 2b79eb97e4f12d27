"""Fused whole TransformerBlock (stride 1, self-attention): hand-written CUDA
kernels and their plain versions.

Replaces the Pallas kernels `_tblock_kernel` / `_tblock_fwd_call` and
`_tblock_bwd_kernel` / `_tblock_diff_bwd` (body `_tblock_compute`,
unav_yolyolva_tpu/ops/pallas_tblock.py:95-316): ln11 and ln12 of x, the
MaskedMHCA (k/v from ln11, q from ln12), `out = x * m + attn * mult_a`, ln2,
fc1 (C -> H), exact erf GELU, fc2 (H -> C), and `out + y * m * mult_m`.
mult_a / mult_m are (R, 1, C): the AffineDropPath scale times the
per-sample stochastic-depth factor (ones in eval).

On the card (csrc/tblock.cu, csrc/tblock_bwd.cu) the block is bound by
operations: the MLP's two products are ~2/3 of its FLOPs at the stem shape.
The forward is eight launches of the repo's own kernels: ln11 + ln12 in one
pass, the MHCA of csrc/mhca.cuh, the residual add fused with ln2, and fc1 /
fc2 on the 3xTF32 tensor-core product (csrc/gemm_tc.cuh) with bias + GELU
and bias + mask + mult_m + residual epilogues. The backward saves only the
inputs, the multipliers and the weights; it recomputes the forward (fc1
writing u and GELU(u) in one launch) and walks back through fc2, GELU' (in
the epilogue of the product that makes du), fc1, ln2, the residual, the
MHCA backward of csrc/mhca_bwd.cuh and ln11 / ln12. Every weight and
multiplier grad is a fixed-order sum (split-K A^T.B, csrc/colsum.cuh,
per-sequence sums): two runs give the same bits.

Under the bf16 compute policy (`cdtype` bfloat16, the JAX package's
`tblock_fused(cdtype=...)`) the residual stream x, the output and the
branch multipliers stay fp32; ln11, ln12 and ln2 store bf16, the MHCA runs
in bf16 (`fused_mhca`), fc1's fp32 sum is rounded to bf16, its bias added
in bf16 and GELU taken of and stored in bf16, fc2 likewise before the row
mask, and `out + y * mult_m` is fp32. On the card it is a launch sequence of
its own (csrc/tblock_bf16.cu: the MHCA of csrc/bf16.cuh, both MLP products
on the `wgmma` product of csrc/bf16_wgmma.cuh with GELU and the residual
tail in its epilogues). Its backward is the JAX package's bf16
`_tblock_bwd_kernel`, `jax.vjp` of the bf16 body once per block of the TPU
kernel's rows: dx and the multipliers' grads fp32, the weight grads rounded
to bf16 per block; the plain version is autograd of the bf16 forward per
block (ops/bf16_grad.py), the kernel csrc/tblock_bwd_bf16.cu (the MLP's six
products on csrc/bf16_wgmma.cuh, u and GELU(u) from fc1's epilogue and du
from dy2 W2's).

Weight layout (torch, packed by TransformerBlock.packed_weights()):
lnw3 / lnb3 (3, C) [ln11, ln12, ln2], the MHCA's dw (3, C, 3), lnw / lnb
(3, C), w (4, C, C), b (4, C), w1 (H, C), b1 (H), w2 (C, H), b2 (C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_build
from .cuda_build import FLOAT, INT, LONG, PTR
from .bf16_grad import pick_rows_tb_bwd, row_blocks
from .fused_mhca import MAX_T, _check, mhca_reference
from .gemm_tc import bf16_product_reference
from .masked import channel_layer_norm
from ..utils.profiling import spanned

_FWD_TYPES = [PTR, PTR, INT, INT, INT, INT, INT, PTR, PTR] + [PTR] * 11 + [FLOAT, PTR, PTR, PTR]
_ARGTYPES = {"unav_tblock_forward": _FWD_TYPES}
_RESTYPES = {"unav_tblock_forward_scratch": ([INT] * 4, LONG)}
_BF16_ARGTYPES = {"unav_tblock_bf16_forward": _FWD_TYPES}
_BF16_RESTYPES = {"unav_tblock_bf16_scratch": ([INT] * 4, LONG)}
_BWD_ARGTYPES = {"unav_tblock_backward": ([PTR, PTR, INT, INT, INT, INT, INT, PTR, PTR]
                                          + [PTR] * 11 + [FLOAT, PTR] + [PTR] * 14 + [PTR, PTR])}
_BWD_RESTYPES = {"unav_tblock_backward_scratch": ([INT] * 5, LONG)}
_BWD_BF16_ARGTYPES = {"unav_tblock_bf16_backward": ([PTR, PTR] + [INT] * 6 + [PTR] * 13
                                                    + [FLOAT] + [PTR] * 15 + [PTR, PTR])}
_BWD_BF16_RESTYPES = {"unav_tblock_bf16_backward_scratch": ([INT] * 5, LONG)}

N_WEIGHTS = 11


def tblock_reference(x, mask, mult_a, mult_m, lnw3, lnb3, dw, lnw, lnb, w, b, w1, b1,
                     w2, b2, *, heads: int, eps: float = 1e-5, linear=F.linear,
                     matmul=torch.matmul, cdtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of the whole block (`_tblock_compute`) at
    compute dtype `cdtype` (fp32 x, multipliers and output). `linear`
    computes the fp32 dense layers (the MHCA's and the MLP's), `matmul` the
    attention's products (the kernels' 3xTF32 rounding: ops/gemm_tc.py);
    in bf16 the products are `bf16_product_reference`."""
    mm = mask[..., None].to(x.dtype)
    h1 = channel_layer_norm(x, lnw3[0], lnb3[0], eps, cdtype)
    h2 = channel_layer_norm(x, lnw3[1], lnb3[1], eps, cdtype)
    attn = mhca_reference(h1, h2, mask, dw, lnw, lnb, w, b, heads=heads, eps=eps,
                          linear=linear, matmul=matmul)
    out = x * mm + attn.to(x.dtype) * mult_a
    h = channel_layer_norm(out, lnw3[2], lnb3[2], eps, cdtype)
    if cdtype != torch.float32:
        y = bf16_product_reference(h, w1, b1, act="gelu")
        y = bf16_product_reference(y, w2, b2, rowmask=mask)
        return out + y.to(x.dtype) * mult_m
    y = linear(F.gelu(linear(h, w1, b1)), w2, b2) * mm
    return out + y * mult_m


def _tblock_grads(x, mask, mult_a, mult_m, g, *weights, heads, eps, cdtype):
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, mult_a, mult_m, *weights)]
        out = tblock_reference(ins[0], mask, *ins[1:], heads=heads, eps=eps, cdtype=cdtype)
        return torch.autograd.grad(out, ins, g)


def tblock_backward_rows(x, *weights, heads: int) -> int:
    """The batch block R of the JAX bf16 backward kernel for these inputs
    (`pick_rows_tb_bwd` at the itemsize of x: 4, the fp32 residual stream,
    as the JAX kernel reads it)."""
    r, t, c = x.shape
    return pick_rows_tb_bwd(r, t, c, weights[7].shape[0], heads, x.element_size())


def tblock_backward_reference(x, mask, mult_a, mult_m, *weights, g, heads: int,
                              eps: float = 1e-5, cdtype: torch.dtype = torch.float32):
    """Plain version of the backward: (dx, d(mult_a), d(mult_m), *weight
    grads), torch.autograd.grad of `tblock_reference` at `cdtype` for the
    upstream g. At bf16 the JAX package's bf16 backward kernel: the grads
    taken once per block of `tblock_backward_rows` rows, each block's weight
    grads added in fp32 (ops/bf16_grad.py); dx and the multipliers' grads
    stay fp32, as the residual stream."""
    if cdtype != torch.bfloat16:
        return _tblock_grads(x, mask, mult_a, mult_m, g, *weights, heads=heads, eps=eps,
                             cdtype=cdtype)
    rows = tblock_backward_rows(x, *weights, heads=heads)

    def block(xb, mb, mab, mmb, gb, *ws):
        return _tblock_grads(xb, mb, mab, mmb, gb, *ws, heads=heads, eps=eps, cdtype=cdtype)

    return row_blocks(block, rows, (x, mask, mult_a, mult_m, g), weights, 3)


def _check_args(x, mask, mult_a, mult_m, weights, heads):
    r, t, c = x.shape
    if len(weights) != N_WEIGHTS:
        raise ValueError(f"fused_tblock: {N_WEIGHTS} packed weights, got {len(weights)}")
    hid = weights[7].shape[0]
    # the products copy rows of 16 bytes: the head width (so C) and the
    # hidden width multiples of 4 floats
    if (c % heads or (c // heads) % 4 or c // heads > 128 or c > 1024 or hid % 4
            or t > MAX_T):
        raise ValueError(f"fused_tblock: unsupported shape (T={t}, C={c}, hidden={hid}, "
                         f"heads={heads})")
    _check(x, "x")
    _check(mask, "mask", (r, t), torch.bool)
    _check(mult_a, "mult_a", (r, 1, c))
    _check(mult_m, "mult_m", (r, 1, c))
    shapes = ((3, c), (3, c), (3, c, 3), (3, c), (3, c), (4, c, c), (4, c), (hid, c), (hid,),
              (c, hid), (c,))
    names = ("lnw3", "lnb3", "dw", "lnw", "lnb", "w", "b", "w1", "b1", "w2", "b2")
    for wt, shape, name in zip(weights, shapes, names):
        _check(wt, name, shape)
    return r, t, c, hid


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_forward(x, mask, mult_a, mult_m, weights, heads, eps):
    r, t, c, hid = _check_args(x, mask, mult_a, mult_m, weights, heads)
    lib = cuda_build.library("tblock", _ARGTYPES, _RESTYPES)
    out = torch.empty_like(x)
    scratch = torch.empty(lib.unav_tblock_forward_scratch(r, t, c, hid),
                          device=x.device, dtype=torch.float32)
    rc = lib.unav_tblock_forward(
        x.data_ptr(), mask.data_ptr(), r, t, c, hid, heads, mult_a.data_ptr(),
        mult_m.data_ptr(), *[wt.data_ptr() for wt in weights], eps, out.data_ptr(),
        scratch.data_ptr(), _stream(x))
    cuda_build.check(lib, rc, "unav_tblock_forward")
    return out


def _launch_forward_bf16(x, mask, mult_a, mult_m, weights, heads, eps):
    r, t, c, hid = _check_args(x, mask, mult_a, mult_m, weights, heads)
    if (c // heads) % 8 or hid % 8:   # bf16 rows of 16 bytes
        raise ValueError(f"fused_tblock (bf16): head width {c // heads} and hidden "
                         f"{hid} must be multiples of 8")
    lib = cuda_build.library("tblock_bf16", _BF16_ARGTYPES, _BF16_RESTYPES)
    out = torch.empty_like(x)
    scratch = torch.empty(lib.unav_tblock_bf16_scratch(r, t, c, hid), device=x.device,
                          dtype=torch.bfloat16)
    rc = lib.unav_tblock_bf16_forward(
        x.data_ptr(), mask.data_ptr(), r, t, c, hid, heads, mult_a.data_ptr(),
        mult_m.data_ptr(), *[wt.data_ptr() for wt in weights], eps, out.data_ptr(),
        scratch.data_ptr(), _stream(x))
    cuda_build.check(lib, rc, "unav_tblock_bf16_forward")
    return out


def _forward_kernel(x, mask, mult_a, mult_m, weights, heads, eps, cdtype=torch.float32):
    if cdtype == torch.bfloat16:
        out = _launch_forward_bf16(x, mask, mult_a, mult_m, weights, heads, eps)
        fused_tblock.bf16_launches += 1
        return out
    if cdtype != torch.float32:
        raise ValueError(f"fused_tblock: compute dtype {cdtype}; the kernels take fp32 or bf16")
    out = _launch_forward(x, mask, mult_a, mult_m, weights, heads, eps)
    fused_tblock.launches += 1
    return out


def _launch_backward(x, mask, mult_a, mult_m, weights, g, heads, eps):
    r, t, c, hid = _check_args(x, mask, mult_a, mult_m, weights, heads)
    _check(g, "g", x.shape)
    grads = [torch.empty_like(a) for a in (x, mult_a, mult_m, *weights)]
    lib = cuda_build.library("tblock_bwd", _BWD_ARGTYPES, _BWD_RESTYPES)
    scratch = torch.empty(lib.unav_tblock_backward_scratch(r, t, c, hid, heads),
                          device=x.device, dtype=torch.float32)
    rc = lib.unav_tblock_backward(
        x.data_ptr(), mask.data_ptr(), r, t, c, hid, heads, mult_a.data_ptr(),
        mult_m.data_ptr(), *[wt.data_ptr() for wt in weights], eps, g.data_ptr(),
        *[gr.data_ptr() for gr in grads], scratch.data_ptr(), _stream(x))
    cuda_build.check(lib, rc, "unav_tblock_backward")
    return tuple(grads)


def _prepare_backward_bf16(x, mask, mult_a, mult_m, weights, g, heads, eps):
    """The bf16 backward's host work before its C entry: the checks, the row
    block, the grads and the scratch. Returns (lib, the entry's arguments,
    grads, scratch)."""
    r, t, c, hid = _check_args(x, mask, mult_a, mult_m, weights, heads)
    if (c // heads) % 8 or hid % 8:   # bf16 rows of 16 bytes
        raise ValueError(f"tblock_backward (bf16): head width {c // heads} and hidden "
                         f"{hid} must be multiples of 8")
    _check(g, "g", x.shape)
    rows = tblock_backward_rows(x, *weights, heads=heads)
    grads = [torch.empty_like(a) for a in (x, mult_a, mult_m, *weights)]
    lib = cuda_build.library("tblock_bwd_bf16", _BWD_BF16_ARGTYPES, _BWD_BF16_RESTYPES)
    scratch = torch.empty(lib.unav_tblock_bf16_backward_scratch(r, t, c, hid, heads),
                          device=x.device, dtype=torch.float32)
    args = (x.data_ptr(), mask.data_ptr(), r, t, c, hid, heads, rows, mult_a.data_ptr(),
            mult_m.data_ptr(), *[wt.data_ptr() for wt in weights], eps, g.data_ptr(),
            *[gr.data_ptr() for gr in grads], scratch.data_ptr(), _stream(x))
    return lib, args, grads, scratch


def _launch_backward_bf16(x, mask, mult_a, mult_m, weights, g, heads, eps):
    lib, args, grads, _ = _prepare_backward_bf16(x, mask, mult_a, mult_m, weights, g, heads,
                                                 eps)
    cuda_build.check(lib, lib.unav_tblock_bf16_backward(*args), "tblock_backward (bf16)")
    return tuple(grads)


@spanned("unav.kernel.tblock_backward")
def tblock_backward(x, mask, mult_a, mult_m, *weights, g, heads: int, eps: float = 1e-5,
                    cdtype: torch.dtype = torch.float32):
    """Grads of the block at compute dtype `cdtype` for the upstream grad g
    (R, T, C): (dx, d(mult_a), d(mult_m), *the 11 weight grads), in the
    layouts of the inputs. CPU tensors take the plain version; CUDA tensors
    launch the kernel of `cdtype`."""
    if x.device.type == "cpu":
        return tblock_backward_reference(x, mask, mult_a, mult_m, *weights, g=g,
                                         heads=heads, eps=eps, cdtype=cdtype)
    if cdtype == torch.bfloat16:
        grads = _launch_backward_bf16(x, mask, mult_a, mult_m, weights, g, heads, eps)
        tblock_backward.bf16_launches += 1
        return grads
    grads = _launch_backward(x, mask, mult_a, mult_m, weights, g, heads, eps)
    tblock_backward.launches += 1
    return grads


class TBlockFunction(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient. Like the
    JAX custom_vjp it saves only the inputs, multipliers and weights; the
    mask gets no grad."""

    @staticmethod
    def forward(ctx, x, mask, mult_a, mult_m, heads, eps, cdtype, *weights):
        ctx.save_for_backward(x, mask, mult_a, mult_m, *weights)
        ctx.heads, ctx.eps, ctx.cdtype = heads, eps, cdtype
        if x.device.type == "cpu":
            return tblock_reference(x, mask, mult_a, mult_m, *weights, heads=heads, eps=eps,
                                    cdtype=cdtype)
        return _forward_kernel(x, mask, mult_a, mult_m, weights, heads, eps, cdtype)

    @staticmethod
    def backward(ctx, g):
        x, mask, mult_a, mult_m, *ws = ctx.saved_tensors
        dx, dma, dmm, *gws = tblock_backward(x, mask, mult_a, mult_m, *ws, g=g.contiguous(),
                                             heads=ctx.heads, eps=ctx.eps, cdtype=ctx.cdtype)
        return (dx, None, dma, dmm, None, None, None, *gws)


@spanned("unav.kernel.tblock")
def fused_tblock(x, mask, mult_a, mult_m, *weights, heads: int, eps: float = 1e-5,
                 cdtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The block's forward of (R, T, C) fp32 x with a (R, T) bool mask and
    (R, 1, C) branch multipliers at compute dtype `cdtype` (fp32 or bf16),
    fp32 out. CPU tensors take the plain version; CUDA tensors launch the
    kernel of `cdtype`. When a grad is needed the call goes through
    TBlockFunction, whose backward is the backward kernel of `cdtype` (on the
    CPU its plain version, by row blocks in bf16), but at fp32 on the CPU,
    where autograd differentiates the plain forward."""
    args = (x, mask, mult_a, mult_m, *weights)
    grad = torch.is_grad_enabled() and any(a.requires_grad for a in args)
    if x.device.type == "cpu" and not (grad and cdtype == torch.bfloat16):
        return tblock_reference(x, mask, mult_a, mult_m, *weights, heads=heads, eps=eps,
                                cdtype=cdtype)
    if grad:
        return TBlockFunction.apply(x, mask, mult_a, mult_m, heads, eps, cdtype, *weights)
    return _forward_kernel(x, mask, mult_a, mult_m, weights, heads, eps, cdtype)


fused_tblock.launches = 0
fused_tblock.bf16_launches = 0
tblock_backward.launches = 0
tblock_backward.bf16_launches = 0
