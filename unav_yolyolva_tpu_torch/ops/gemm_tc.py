"""The port's fp32 product on the tensor cores, alone, and its plain version.

    out[m, n] = act(sum_k A(m, k) B(n, k) + bias[n]) * scale * rowmask[m]
                * seqmul[m // seq, n] (+ out)

`csrc/gemm_tc.cuh` runs every product of the port's kernels (the fp32
`jnp.dot`s of `_mhca_compute`, `_csp_compute`, `_tblock_compute` and their
backward kernels in the JAX package) in 3xTF32: each operand is split
as hi = tf32(x), lo = tf32(x - hi), and lo.hi + hi.lo + hi.hi is summed in
fp32 on the tensor cores, each 32-deep slice of k from zero. It takes three
layouts: A.B^T (the forward), A.B (the input grads: B stored (K, N), A
optionally the transposed k=3 conv) and A^T.B (the weight grads: A stored
(K, M) with masked k rows, B optionally the k=3 conv's shifted rows, K
split into chunks fixed by the product's shape, `split_chunk`, whose sums
are added in order). One A.B^T or A.B product may take the TBlock MLP's
epilogue instead of being batched: act "gelu" (exact erf GELU, its input
optionally written to `pre_out` as well) or "gelu_grad" (the product times
GELU'(aux)), the per-sequence multiplier `seqmul` (M // seq, N), and `beta`
on the forward layout. This module exposes that product by itself
(`tf32x3_linear`, `tf32x3_products`) so that it can be tested and timed
alone, and holds the plain emulation of its rounding scheme
(`tf32x3_linear_reference`, `tf32x3_matmul_reference`,
`tf32x3_product_reference`) that the CPU tests route the plain MHCA and
CSP versions through. The emulation rounds, splits and orders slices and
chunks exactly as the kernel does; its fp32 sums are rounded to nearest,
the tensor cores' partial sums are not, so it matches the kernel's error
budget, not its bits.

The bf16 compute policy's product (`csrc/bf16.cuh`, `bf16_products`) is
the JAX package's `jnp.dot(a.astype(bf16), w.astype(bf16),
preferred_element_type=f32)` followed by `.astype(bf16)` and the bias
added in bf16: one mma.m16n8k16 per 16-deep step, fp32 sums, each 32-deep
slice of k from zero, then the epilogue in the JAX order (round, + bias,
GELU, scale, row mask, each rounded to bf16). Its plain version,
`bf16_product_reference`, rounds the operands to bf16, multiplies them in
fp32 (the products of bf16 values are exact there) and rounds the sum to
bf16; the port's bf16 products on the CPU (the kernels' plain versions)
run through it. The backward's bf16 product (`bf16_layout_product`, the
kernel of csrc/bf16_bwd.cuh) adds the A.B and A^T.B layouts, an fp32 A taken
exactly, and a weight grad's K summed in row blocks whose fp32 sums are
rounded to bf16 and added in fp32 in order (`bf16_layout_reference`).
The whole-block TBlock's MLP products run on a third bf16 product
(`mlp_product`, the kernel of csrc/bf16_wgmma.cuh: wgmma fed by TMA, the
same 32-deep slices and row blocks) in the A.B^T, A.B and A^T.B layouts,
with the epilogues that block needs: + bias and GELU (fc1), u and GELU(u)
both kept (fc1 in the backward's recompute), the residual tail (fc2),
GELU'(u) times the product (the backward's du); its plain version is
`mlp_product_reference`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build
from .bf16_grad import bias_add
from .cuda_build import FLOAT, INT, LONG, PTR

_ARGTYPES = {"unav_gemm_tc": [INT, PTR, PTR, PTR, PTR, LONG, PTR],
             "unav_gemm_split_chunk": [INT, INT, INT]}
_BF16_ARGTYPES = {"unav_gemm_bf16": [INT, PTR, PTR, PTR, PTR],
                  "unav_xgemm_bf16": [INT] * 6 + [PTR, INT, PTR, PTR, INT, FLOAT, PTR],
                  "unav_wgmma_bf16": [INT] * 6 + [PTR, LONG, PTR, LONG, PTR, LONG] + [PTR] * 5
                  + [INT, PTR]}
SLICE = 32          # k summed from zero before it joins the total (TC_BK)
MAX_BATCH = 4       # products of one launch (GEMM_MAX_BATCH)
MAX_SPLITS = 8      # chunks of K of a weight grad (GEMM_MAX_SPLITS)
SMS = 132           # the H100's SMs, which the split of K aims to fill twice
ACTS = {"none": 0, "gelu": 1, "gelu_grad": 2}    # the epilogue's act (GEMM_ACT_*)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def split_chunk(m: int, n: int, k: int) -> int:
    """K per chunk of a weight grad (A^T.B) of shape (m, n, k), a multiple of
    SLICE fixed by the product's own shape (gemm_tc.cuh:gemm_split_chunk):
    split until its 64x64 tiles make ~2 blocks per SM, each chunk at least
    8 slices deep."""
    tiles = _ceil_div(m, 64) * _ceil_div(n, 64)
    slices = _ceil_div(k, SLICE)
    s = max(1, min(MAX_SPLITS, _ceil_div(2 * SMS, tiles), slices // 8))
    return _ceil_div(slices, s) * SLICE


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (fp32) rounded to TF32, 10 explicit mantissa bits, to nearest with
    ties away from zero (cvt.rna.tf32.f32): add half of the last kept bit
    to the magnitude, then clear the 13 low bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32x3_split(x: torch.Tensor):
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def tf32x3_matmul_reference(a: torch.Tensor, b: torch.Tensor, kchunk: int = None
                            ) -> torch.Tensor:
    """a @ b (batched as torch.matmul) as the kernels compute it: per
    32-deep slice of k, lo.hi + hi.lo, then + hi.hi, in fp32; the slices
    summed in order. With kchunk (a multiple of SLICE), K is summed in
    chunks of kchunk, each from zero, and the chunks' sums added in order
    (a weight grad's split K)."""
    ah, al = tf32x3_split(a)
    bh, bl = tf32x3_split(b)
    k = a.shape[-1]
    out = None
    for c0 in range(0, k, kchunk or k):
        chunk = None
        for k0 in range(c0, min(k, c0 + (kchunk or k)), SLICE):
            ka, kb = (..., slice(k0, k0 + SLICE)), (..., slice(k0, k0 + SLICE), slice(None))
            part = al[ka] @ bh[kb] + ah[ka] @ bl[kb]
            part = part + ah[ka] @ bh[kb]
            chunk = part if chunk is None else chunk + part
        out = chunk if out is None else out + chunk
    return out


def conv3_taps(x: torch.Tensor, seq: int, tapdir: int = 1) -> torch.Tensor:
    """The k=3 "same" conv's operand as one product of depth 3*Kc: rows of
    x (M, Kc) are (sequence, t) with t = m % seq; row m of the result is
    [x[m-1], x[m], x[m+1]] with zeros outside the sequence (tap-major, as
    the kernel's loader reads it), or [x[m+1], x[m], x[m-1]] with tapdir -1
    (the transposed conv of the backward)."""
    r = x.reshape(-1, seq, x.shape[-1])
    left = F.pad(r[:, :-1], (0, 0, 1, 0))
    right = F.pad(r[:, 1:], (0, 0, 0, 1))
    taps = [left, r, right] if tapdir == 1 else [right, r, left]
    return torch.cat(taps, -1).reshape(x.shape[0], -1)


def tf32x3_linear_reference(x, w, bias=None, *, rowmask=None, scale: float = 1.0,
                            taps: int = 1, seq: int = 1) -> torch.Tensor:
    """Plain version of `tf32x3_linear`: x (..., K) (with taps == 3, x is
    (M, Kc) and K = 3*Kc), w (N, K)."""
    a = conv3_taps(x, seq) if taps == 3 else x
    y = tf32x3_matmul_reference(a, w.transpose(0, 1))
    if bias is not None:
        y = y + bias
    y = y * scale
    return y * rowmask[..., None].to(y.dtype) if rowmask is not None else y


def gelu_erf(u: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU as the epilogue computes it (gemm_tc.cuh:gelu_erf)."""
    return 0.5 * u * (1.0 + torch.erf(u * 0.70710678118654752))


def gelu_erf_grad(u: torch.Tensor) -> torch.Tensor:
    """GELU'(u) as the epilogue computes it (gemm_tc.cuh:gelu_erf_grad)."""
    return (0.5 * (1.0 + torch.erf(u * 0.70710678118654752))
            + u * 0.39894228040143268 * torch.exp(-0.5 * u * u))


def tf32x3_product_reference(x, w, bias=None, *, rowmask=None, kmask=None,
                             scale: float = 1.0, taps: int = 1, tapdir: int = 1,
                             btaps: int = 1, seq: int = 1, trans_a: bool = False,
                             trans_b: bool = False, out=None, beta: bool = False,
                             act: str = "none", aux=None, seqmul=None, pre_out=None
                             ) -> torch.Tensor:
    """Plain version of one product of `tf32x3_products` in any layout:
    A.B^T (x (M, K) or, with taps == 3, the k=3 conv of x (M, Kc) in
    direction tapdir; w (N, K)), A.B (the same x, w stored (K, N)) or
    A^T.B (trans_a and trans_b: x stored (K, M), its rows zeroed where
    kmask is False; w (K, N) or, with btaps == 3, the conv's shifted rows
    of w (K, Kc), N = 3*Kc; K summed in chunks of `split_chunk`). The
    epilogue, in the kernel's order: bias; act "gelu" (its input copied to
    pre_out when given) or "gelu_grad" (times GELU'(aux)); scale and
    rowmask; seqmul (M // seq, N) row m // seq; with beta the result is
    added to out."""
    if trans_a and not trans_b:
        raise ValueError("tf32x3_product_reference: trans_a needs trans_b")
    if trans_a:
        a = x if kmask is None else x * kmask[:, None].to(x.dtype)
        b = conv3_taps(w, seq) if btaps == 3 else w
        y = tf32x3_matmul_reference(a.transpose(0, 1), b,
                                    split_chunk(a.shape[1], b.shape[1], a.shape[0]))
    else:
        a = conv3_taps(x, seq, tapdir) if taps == 3 else x
        y = tf32x3_matmul_reference(a, w if trans_b else w.transpose(0, 1))
    if bias is not None:
        y = y + bias
    if act not in ACTS:
        raise ValueError(f"tf32x3_product_reference: act {act!r}, expected one of {list(ACTS)}")
    if act == "gelu":
        if pre_out is not None:
            pre_out.copy_(y)
        y = gelu_erf(y)
    elif act == "gelu_grad":
        y = y * gelu_erf_grad(aux)
    y = y * scale
    if rowmask is not None:
        y = y * rowmask[..., None].to(y.dtype)
    if seqmul is not None:
        y = y * seqmul.repeat_interleave(seq, 0)
    return out + y if beta else y


_LAYOUT_KEYS = ("bias", "rowmask", "kmask", "scale", "taps", "tapdir", "btaps", "seq",
                "trans_a", "trans_b", "act", "aux", "seqmul", "pre_out")
_EPI_KEYS = ("aux", "seqmul", "pre_out")


def _check(name, t, dims, dtype=torch.float32):
    if t.device.type != "cuda" or t.dtype != dtype or t.dim() != dims:
        raise ValueError(f"{name}: needs a {dims}-d {dtype} CUDA tensor, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _epilogue(c) -> bool:
    """Whether a call takes the epilogue kernel: an act, a GemmEpi operand,
    or beta on the forward layout."""
    return (c.get("act", "none") != "none" or any(c.get(k) is not None for k in _EPI_KEYS)
            or (bool(c.get("beta")) and not c.get("trans_b")))


def tf32x3_products(calls):
    """Run up to four products as the MHCA and CSP kernels batch them (one
    launch per layout present, a weight grad's split K reduced in a second),
    or one product with the epilogue as the TBlock kernels run it. Each call
    is a dict of `tf32x3_product_reference`'s arguments (`x`, `w`, optional
    `bias`, `rowmask`, `kmask`, `scale`, `taps`, `tapdir`, `btaps`, `seq`,
    `trans_a`, `trans_b`, `out`, `beta`, `act`, `aux`, `seqmul`,
    `pre_out`). Returns the outputs. CPU tensors take the plain version."""
    if not 1 <= len(calls) <= MAX_BATCH:
        raise ValueError(f"tf32x3_products: 1 to {MAX_BATCH} products, got {len(calls)}")
    if len(calls) > 1 and any(_epilogue(c) for c in calls):
        raise ValueError("tf32x3_products: a product with the epilogue runs alone")
    if calls[0]["x"].device.type == "cpu":
        outs = []
        for c in calls:
            y = tf32x3_product_reference(c["x"], c["w"], out=c.get("out"),
                                         beta=c.get("beta", False),
                                         **{k: c[k] for k in _LAYOUT_KEYS if k in c})
            if c.get("out") is not None:
                c["out"].copy_(y)
                y = c["out"]
            outs.append(y)
        return outs
    ptrs, ints, scales, outs = [], [], [], []
    part_floats = 0
    for c in calls:
        x, w = c["x"], c["w"]
        taps, tapdir, btaps, seq = (c.get("taps", 1), c.get("tapdir", 1), c.get("btaps", 1),
                                    c.get("seq", 1))
        ta, tb = bool(c.get("trans_a", False)), bool(c.get("trans_b", False))
        _check("x", x, 2)
        _check("w", w, 2)
        if ta:
            k, m = x.shape
            n = btaps * w.shape[1]
            ok = tb and taps == 1 and w.shape[0] == k
        else:
            m, kc = x.shape
            k, n = (w.shape[0], w.shape[1]) if tb else (w.shape[1], w.shape[0])
            ok = btaps == 1 and k == taps * kc and (tb or tapdir == 1)
        if (not ok or taps not in (1, 3) or btaps not in (1, 3) or tapdir not in (1, -1)
                or x.stride(1) != 1 or not w.is_contiguous()):
            raise ValueError(f"tf32x3_products: x {tuple(x.shape)} (strides {x.stride()}), "
                             f"w {tuple(w.shape)}, taps {taps}/{tapdir}, btaps {btaps}, "
                             f"trans_a {ta}, trans_b {tb}")
        out = c.get("out")
        if out is None:
            if c.get("beta"):
                raise ValueError("tf32x3_products: beta needs out")
            out = torch.empty((m, n), device=x.device, dtype=torch.float32)
        _check("out", out, 2)
        if tuple(out.shape) != (m, n) or out.stride(1) != 1:
            raise ValueError(f"out: shape {tuple(out.shape)}, strides {out.stride()}")
        bias, rowmask, kmask = c.get("bias"), c.get("rowmask"), c.get("kmask")
        if bias is not None:
            _check("bias", bias, 1)
        for name, mk in (("rowmask", rowmask), ("kmask", kmask)):
            if mk is not None:
                _check(name, mk, 1, torch.bool)
        # the kernel's ring copies 16-byte chunks along each operand's rows
        if (x.data_ptr() % 16 or w.data_ptr() % 16 or x.stride(0) % 4 or w.stride(0) % 4
                or (m if ta else k // taps) % 4 or (w.shape[1] if tb else k) % 4 or n % 2
                or out.stride(0) % 2 or out.data_ptr() % 8):
            raise ValueError("tf32x3_products: x and w need 16-byte aligned rows "
                             "(strides and the copied dimension multiples of 4 floats), "
                             "N and out's row stride even")
        if ta:
            chunks = _ceil_div(k, split_chunk(m, n, k))
            if chunks > 1:
                part_floats += chunks * m * n
        epi, act = _epilogue(c), c.get("act", "none")
        aux, seqmul, pre = (c.get(key) for key in _EPI_KEYS)
        if epi and (ta or act not in ACTS or (act == "gelu_grad") != (aux is not None)
                    or (pre is not None and act != "gelu")):
            raise ValueError(f"tf32x3_products: epilogue act {act!r} with aux "
                             f"{aux is not None}, pre_out {pre is not None}, trans_a {ta}")
        # the epilogue reads and writes aux, pre_out and seqmul as float pairs
        for name, ten, shape in (("aux", aux, (m, n)), ("pre_out", pre, (m, n)),
                                 ("seqmul", seqmul, (m // seq, n))):
            if ten is None:
                continue
            _check(name, ten, 2)
            if (tuple(ten.shape) != shape or ten.stride(1) != 1 or ten.stride(0) % 2
                    or ten.data_ptr() % 8 or (name == "seqmul" and (m % seq or
                                                                   not ten.is_contiguous()))):
                raise ValueError(f"{name}: shape {tuple(ten.shape)}, strides {ten.stride()}; "
                                 f"needs {shape}, even row stride, 8-byte aligned")
        ptrs += [x.data_ptr(), w.data_ptr(), out.data_ptr()] + [
            a.data_ptr() if a is not None else None
            for a in (bias, rowmask, kmask, aux, seqmul, pre)]
        ints += [x.stride(0), w.stride(0), out.stride(0), m, n, k, taps, seq, tapdir, btaps,
                 int(ta), int(tb), int(bool(c.get("beta", False))), int(epi), ACTS[act],
                 aux.stride(0) if aux is not None else 0,
                 pre.stride(0) if pre is not None else 0]
        scales.append(float(c.get("scale", 1.0)))
        outs.append(out)
    dev = outs[0].device
    part = torch.empty(part_floats, device=dev, dtype=torch.float32) if part_floats else None
    lib = cuda_build.library("gemm_tc", _ARGTYPES)
    rc = lib.unav_gemm_tc(
        len(calls), (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_long * len(ints))(*ints),
        (ctypes.c_float * len(scales))(*scales),
        part.data_ptr() if part is not None else None, part_floats,
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, rc, "tf32x3_products")
    tf32x3_linear.launches += 1
    return outs


def kernel_split_chunk(m: int, n: int, k: int) -> int:
    """The kernel library's own K per chunk of a weight grad (m, n, k), to
    hold `split_chunk` against; needs the CUDA toolkit."""
    return cuda_build.library("gemm_tc", _ARGTYPES).unav_gemm_split_chunk(m, n, k)


def tf32x3_linear(x, w, bias=None, *, rowmask=None, scale: float = 1.0, taps: int = 1,
                  seq: int = 1, out=None) -> torch.Tensor:
    """(x w^T + bias) * scale * rowmask of x (M, K) (a row-strided view is
    read in place; with taps == 3 the k=3 "same" conv over sequences of
    `seq` rows, x (M, Kc), w (N, 3*Kc) tap-major) into out (M, N) (new, or
    a row-strided view written in place). CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    return tf32x3_products([dict(x=x, w=w, bias=bias, rowmask=rowmask, scale=scale,
                                 taps=taps, seq=seq, out=out)])[0]


tf32x3_linear.launches = 0


# ---- the bf16 compute policy's product ----------------------------------------

BF16_ACTS = {"none": 0, "gelu": 1}     # the bf16 epilogue's act (csrc/bf16.cuh)


def bf16_matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (batched as torch.matmul) of the operands rounded to bf16, in
    fp32: the exact products of bf16 values summed in fp32."""
    return torch.matmul(a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float())


def bf16_product_reference(x, w, bias=None, *, rowmask=None, scale: float = 1.0,
                           taps: int = 1, seq: int = 1, act: str = "none", out=None,
                           seqmul=None, raw: bool = False) -> torch.Tensor:
    """Plain version of one product of `bf16_products`: x (..., K) (with
    taps == 3 the k=3 conv of x (M, Kc), K = 3*Kc), w (N, K) fp32 or bf16,
    both rounded to bf16, their fp32 product rounded to bf16; then, each
    step rounded to bf16: + bias, act "gelu" (exact erf GELU of the bf16
    value in fp32), times bf16(scale), times rowmask. With seqmul (M // seq,
    N) fp32 the result is out + y * seqmul[m // seq] in fp32 (the TBlock's
    residual tail); with raw the fp32 sum alone."""
    a = conv3_taps(x, seq) if taps == 3 else x
    y = bf16_matmul_reference(a, w.transpose(0, 1))
    if raw:
        return y
    y = y.to(torch.bfloat16)
    if bias is not None:
        y = bias_add(y, bias.to(torch.bfloat16))
    if act not in BF16_ACTS:
        raise ValueError(f"bf16_product_reference: act {act!r}, expected one of "
                         f"{list(BF16_ACTS)}")
    if act == "gelu":
        y = gelu_erf(y.float()).to(torch.bfloat16)
    if scale != 1.0:
        y = y * torch.tensor(scale, dtype=torch.bfloat16)
    if rowmask is not None:
        y = y * rowmask[..., None].to(y.dtype)
    if seqmul is not None:
        return out + y.float() * seqmul.repeat_interleave(seq, 0).reshape(y.shape)
    return y


def bf16_layout_reference(a, b, layout: str, *, kblock: int = None, round_blocks: bool = False,
                          out_bf16: bool = True, scale: float = 1.0) -> torch.Tensor:
    """Plain version of the backward's strided bf16 product
    (csrc/bf16_bwd.cuh:xgemm) in one of its layouts: "nt" a (M, K) . b (N,
    K)^T, "nn" a (M, K) . b (K, N), "tn" a (K, M)^T . b (K, N). a is bf16 or
    fp32 (an fp32 a is taken exactly: the kernel splits it into three bf16
    terms), b is rounded to bf16; the products are exact in fp32. K is summed
    in blocks of kblock rows (default all of K), each from zero, and the
    blocks added in fp32 in order, each block's sum rounded to bf16 first
    with round_blocks (a JAX row block's bf16 weight grad). The result is
    rounded to bf16, then times bf16(scale) rounded again, with out_bf16;
    else the fp32 sum."""
    if layout not in ("nt", "nn", "tn"):
        raise ValueError(f"bf16_layout_reference: layout {layout!r}")
    a = a.float() if a.dtype == torch.float32 else a.to(torch.bfloat16).float()
    b = b.to(torch.bfloat16).float()
    a = a.transpose(-1, -2) if layout == "tn" else a
    b = b.transpose(-1, -2) if layout == "nt" else b
    k = a.shape[-1]
    out = None
    for k0 in range(0, k, kblock or k):
        blk = (a[..., k0:k0 + (kblock or k)].double() @ b[..., k0:k0 + (kblock or k), :].double()
               ).float()
        if round_blocks:
            blk = blk.to(torch.bfloat16).float()
        out = blk if out is None else out + blk
    if not out_bf16:
        return out
    y = out.to(torch.bfloat16)
    return y * torch.tensor(scale, dtype=torch.bfloat16) if scale != 1.0 else y


def bf16_layout_product(a, b, layout: str, *, kblock: int = None, round_blocks: bool = False,
                        out_bf16: bool = True, scale: float = 1.0) -> torch.Tensor:
    """One product of the backward's strided bf16 kernel (xgemm) in `layout`
    on contiguous operands, as `bf16_layout_reference` describes it (an fp32
    a in the "nn" and "tn" layouts). CPU tensors take that plain version;
    CUDA tensors launch the kernel."""
    if a.device.type == "cpu":
        return bf16_layout_reference(a, b, layout, kblock=kblock, round_blocks=round_blocks,
                                     out_bf16=out_bf16, scale=scale)
    if (layout not in ("nt", "nn", "tn") or a.dim() != 2 or b.dim() != 2
            or a.dtype not in (torch.float32, torch.bfloat16) or b.dtype != torch.bfloat16
            or not a.is_contiguous() or not b.is_contiguous()):
        raise ValueError(f"bf16_layout_product: layout {layout!r}, a {a.dtype} "
                         f"{tuple(a.shape)}, b {b.dtype} {tuple(b.shape)}")
    m, k = a.shape if layout != "tn" else a.shape[::-1]
    n = b.shape[0] if layout == "nt" else b.shape[1]
    if (b.shape[1] if layout == "nt" else b.shape[0]) != k:
        raise ValueError(f"bf16_layout_product: a {tuple(a.shape)} and b {tuple(b.shape)} "
                         f"do not chain in layout {layout!r}")
    out = torch.empty((m, n), device=a.device,
                      dtype=torch.bfloat16 if out_bf16 else torch.float32)
    lib = cuda_build.library("gemm_bf16", _BF16_ARGTYPES)
    rc = lib.unav_xgemm_bf16(
        ("nt", "nn", "tn").index(layout), m, n, k, kblock or k, int(round_blocks),
        a.data_ptr(), int(a.dtype == torch.float32), b.data_ptr(), out.data_ptr(),
        int(not out_bf16), float(torch.tensor(scale, dtype=torch.bfloat16)),
        torch.cuda.current_stream(a.device).cuda_stream)
    cuda_build.check(lib, rc, "bf16_layout_product")
    return out


def bf16_products(calls):
    """Run up to four products of the bf16 policy in one launch (the
    kernels' products: A.B^T, the k=3 conv loader on A, the epilogue of
    `bf16_product_reference`). Each call is a dict of x (M, K) bf16 (a
    row-strided view is read in place), w (N, K) bf16, and optional bias
    (N) bf16, rowmask (M) bool, scale, taps, seq, act, out (M, N) (bf16;
    fp32 with seqmul or raw), seqmul (M // seq, N) fp32, raw. Returns the
    outputs. CPU tensors take the plain version; CUDA tensors launch the
    kernel (rows of 16 bytes: K, the row strides and Kc multiples of 8, N
    even)."""
    if not 1 <= len(calls) <= MAX_BATCH:
        raise ValueError(f"bf16_products: 1 to {MAX_BATCH} products, got {len(calls)}")
    if calls[0]["x"].device.type == "cpu":
        outs = []
        for c in calls:
            y = bf16_product_reference(
                c["x"], c["w"], c.get("bias"), rowmask=c.get("rowmask"),
                scale=c.get("scale", 1.0), taps=c.get("taps", 1), seq=c.get("seq", 1),
                act=c.get("act", "none"), out=c.get("out"), seqmul=c.get("seqmul"),
                raw=c.get("raw", False))
            if c.get("out") is not None:
                c["out"].copy_(y)
                y = c["out"]
            outs.append(y)
        return outs
    bf = torch.bfloat16
    ptrs, ints, scales, outs = [], [], [], []
    for c in calls:
        x, w = c["x"], c["w"]
        taps, seq, act = c.get("taps", 1), c.get("seq", 1), c.get("act", "none")
        seqmul, raw = c.get("seqmul"), bool(c.get("raw", False))
        _check("x", x, 2, bf)
        _check("w", w, 2, bf)
        m, kc = x.shape
        n, k = w.shape
        if (taps not in (1, 3) or k != taps * kc or x.stride(1) != 1 or not w.is_contiguous()
                or act not in BF16_ACTS or (raw and (seqmul is not None or act != "none"))):
            raise ValueError(f"bf16_products: x {tuple(x.shape)} (strides {x.stride()}), "
                             f"w {tuple(w.shape)}, taps {taps}, act {act!r}, raw {raw}")
        wide = seqmul is not None or raw
        out = c.get("out")
        if out is None:
            if seqmul is not None:
                raise ValueError("bf16_products: seqmul needs out")
            out = torch.empty((m, n), device=x.device, dtype=torch.float32 if raw else bf)
        _check("out", out, 2, torch.float32 if wide else bf)
        if tuple(out.shape) != (m, n) or out.stride(1) != 1:
            raise ValueError(f"out: shape {tuple(out.shape)}, strides {out.stride()}")
        bias, rowmask = c.get("bias"), c.get("rowmask")
        if bias is not None:
            _check("bias", bias, 1, bf)
        if rowmask is not None:
            _check("rowmask", rowmask, 1, torch.bool)
        if seqmul is not None:
            _check("seqmul", seqmul, 2)
            if m % seq or tuple(seqmul.shape) != (m // seq, n) or not seqmul.is_contiguous():
                raise ValueError(f"seqmul: shape {tuple(seqmul.shape)}, needs {(m // seq, n)}")
        # the ring copies 16-byte chunks (8 bf16) along the rows of x and w
        if (x.data_ptr() % 16 or w.data_ptr() % 16 or x.stride(0) % 8 or k % 8 or kc % 8
                or n % 2 or out.stride(0) % 2 or out.data_ptr() % (8 if wide else 4)):
            raise ValueError("bf16_products: x and w need 16-byte aligned rows (K, Kc and "
                             "the row strides multiples of 8), N and out's row stride even")
        ptrs += [x.data_ptr(), w.data_ptr(), out.data_ptr()] + [
            a.data_ptr() if a is not None else None for a in (bias, rowmask, seqmul)]
        ints += [x.stride(0), w.stride(0), out.stride(0), m, n, k, taps, seq,
                 BF16_ACTS[act], int(raw)]
        scales.append(float(torch.tensor(c.get("scale", 1.0), dtype=bf)))
        outs.append(out)
    dev = outs[0].device
    lib = cuda_build.library("gemm_bf16", _BF16_ARGTYPES)
    rc = lib.unav_gemm_bf16(
        len(calls), (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_long * len(ints))(*ints),
        (ctypes.c_float * len(scales))(*scales), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, rc, "bf16_products")
    bf16_products.launches += 1
    return outs


bf16_products.launches = 0


# ---- the whole-block TBlock's MLP product (csrc/bf16_wgmma.cuh) --------------------

MLP_EPIS = {"raw": 0, "store": 1, "gelu": 2, "ua": 3, "res": 4, "du": 5}   # WG_*
MLP_LAYOUT_EPIS = {"nt": ("raw", "store", "gelu", "ua", "res"), "nn": ("raw", "store", "du"),
                   "tn": ("raw",)}


def mlp_product_reference(x, w, layout: str = "nt", epi: str = "store", *, bias=None,
                          rowmask=None, u=None, out=None, seqmul=None, seq: int = 1,
                          kblock: int = None):
    """Plain version of one `mlp_product`: x (M, K) . w^T with w (N, K)
    (layout "nt"), x . w with w (K, N) ("nn"), or x^T . w with x (K, M)
    ("tn", a weight grad: K in blocks of kblock rows, each block's fp32 sum
    rounded to bf16 and the blocks added in fp32 in order), the operands
    rounded to bf16, their fp32 product; then the epilogue, each step
    rounded to bf16: "raw" the fp32 sums; "store" bf16(sum) [+ bias] [*
    rowmask]; "gelu" + bias, erf GELU; "ua" (u, a) with u = bf16(sum) +
    bias and a = GELU(u); "res" out + (bf16(sum) + bias) * rowmask *
    seqmul[m // seq] in fp32; "du" bf16(GELU'(u) * bf16(sum))."""
    if layout not in MLP_LAYOUT_EPIS or epi not in MLP_LAYOUT_EPIS[layout]:
        raise ValueError(f"mlp_product_reference: layout {layout!r}, epi {epi!r}")
    if layout == "tn":
        return bf16_layout_reference(x.to(torch.bfloat16), w, "tn", kblock=kblock,
                                     round_blocks=True, out_bf16=False)
    y = bf16_matmul_reference(x, w.transpose(0, 1) if layout == "nt" else w)
    if epi == "raw":
        return y
    y = y.to(torch.bfloat16)
    if epi == "du":
        return (gelu_erf_grad(u.float()) * y.float()).to(torch.bfloat16)
    if bias is not None:
        y = bias_add(y, bias.to(torch.bfloat16))
    if epi == "ua":
        return y, gelu_erf(y.float()).to(torch.bfloat16)
    if epi == "gelu":
        y = gelu_erf(y.float()).to(torch.bfloat16)
    if rowmask is not None:
        y = y * rowmask[..., None].to(y.dtype)
    if epi == "res":
        return out + y.float() * seqmul.repeat_interleave(seq, 0).reshape(y.shape)
    return y


def mlp_product(x, w, layout: str = "nt", epi: str = "store", *, bias=None, rowmask=None,
                u=None, out=None, seqmul=None, seq: int = 1, kblock: int = None):
    """One product of the whole-block TBlock's MLP (csrc/bf16_wgmma.cuh), as
    `mlp_product_reference` describes it: x (M, K) bf16, w bf16 (N, K) in
    layout "nt" (fc1, fc2) or (K, N) in "nn" (the backward's dy2 W2 and du
    W1); in "tn" x (K, M) and w (K, N) (the weight grads, "raw" only, K in
    blocks of kblock rows); contiguous; "res" adds into out (M, N) fp32 in
    place and returns it; "ua" returns (u, a). CPU tensors take the plain
    version; CUDA tensors launch the kernel (rows of 16 bytes: the row
    widths, and K outside "tn", multiples of 8)."""
    if x.device.type == "cpu":
        return mlp_product_reference(x, w, layout, epi, bias=bias, rowmask=rowmask, u=u,
                                     out=out, seqmul=seqmul, seq=seq, kblock=kblock)
    bf = torch.bfloat16
    if layout not in MLP_LAYOUT_EPIS or epi not in MLP_LAYOUT_EPIS[layout]:
        raise ValueError(f"mlp_product: layout {layout!r}, epi {epi!r}")
    _check("x", x, 2, bf)
    _check("w", w, 2, bf)
    m, k = x.shape[::-1] if layout == "tn" else x.shape
    n = w.shape[0] if layout == "nt" else w.shape[1]
    kb = kblock or k
    if ((w.shape[1] if layout == "nt" else w.shape[0]) != k or not x.is_contiguous()
            or not w.is_contiguous() or (layout != "tn" and k % 8) or n % 8
            or (layout == "tn" and m % 8) or k % kb or (kblock and layout != "tn")):
        raise ValueError(f"mlp_product: x {tuple(x.shape)}, w {tuple(w.shape)} in layout "
                         f"{layout!r}, kblock {kblock} (contiguous, the rows' widths and "
                         f"K outside 'tn' multiples of 8, K whole blocks)")
    wide = epi in ("raw", "res")
    if epi == "res":
        if out is None or seqmul is None or m % seq:
            raise ValueError("mlp_product: 'res' needs out and seqmul (M // seq, N)")
        _check("seqmul", seqmul, 2)
        if tuple(seqmul.shape) != (m // seq, n) or not seqmul.is_contiguous():
            raise ValueError(f"seqmul: shape {tuple(seqmul.shape)}, needs {(m // seq, n)}")
    else:
        out = torch.empty((m, n), device=x.device, dtype=torch.float32 if wide else bf)
    _check("out", out, 2, torch.float32 if wide else bf)
    if tuple(out.shape) != (m, n) or not out.is_contiguous():
        raise ValueError(f"out: shape {tuple(out.shape)}, needs {(m, n)} contiguous")
    a = torch.empty_like(out) if epi == "ua" else None
    if epi == "du":
        _check("u", u, 2, bf)
        if tuple(u.shape) != (m, n) or not u.is_contiguous():
            raise ValueError(f"u: shape {tuple(u.shape)}, needs {(m, n)} contiguous")
    if bias is not None:
        _check("bias", bias, 1, bf)
    if rowmask is not None:
        _check("rowmask", rowmask, 1, torch.bool)
    if (bias is not None and tuple(bias.shape) != (n,)) or (
            rowmask is not None and tuple(rowmask.shape) != (m,)):
        raise ValueError(f"mlp_product: bias needs ({n},), rowmask ({m},)")

    def ptr(t):
        return t.data_ptr() if t is not None else None

    lib = cuda_build.library("gemm_bf16", _BF16_ARGTYPES)
    rc = lib.unav_wgmma_bf16(
        ("nt", "nn", "tn").index(layout), MLP_EPIS[epi], m, n, k,
        kb if layout == "tn" else 0, x.data_ptr(), x.stride(0), w.data_ptr(),
        w.stride(0), out.data_ptr(), n, ptr(a), ptr(u if epi == "du" else None), ptr(bias),
        ptr(rowmask), ptr(seqmul if epi == "res" else None), seq,
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, rc, "mlp_product")
    mlp_product.launches += 1
    return (out, a) if epi == "ua" else out


mlp_product.launches = 0
