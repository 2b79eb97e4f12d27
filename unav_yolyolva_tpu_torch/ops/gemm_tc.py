"""The port's forward-layout fp32 product on the tensor cores, alone, and its
plain version.

    out[m, n] = (sum_k A(m, k) w[n, k] + bias[n]) * scale * rowmask[m]

`csrc/gemm_tc.cuh` runs every A.B^T product of the MHCA and CSP kernels
(the fp32 `jnp.dot`s of `_mhca_compute` and `_csp_compute` in the JAX
package) in 3xTF32: each operand is split as hi = tf32(x), lo = tf32(x -
hi), and lo.hi + hi.lo + hi.hi is summed in fp32 on the tensor cores, each
32-deep slice of k from zero. This module exposes that product by itself
(`tf32x3_linear`, `tf32x3_products`) so that it can be tested and timed
alone, and holds the plain emulation of its rounding scheme
(`tf32x3_linear_reference`, `tf32x3_matmul_reference`) that the CPU tests
route the plain MHCA and CSP versions through. The emulation rounds and
splits exactly as the kernel does; its fp32 sums are rounded to nearest,
the tensor cores' partial sums are not, so it matches the kernel's error
budget, not its bits.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build
from .cuda_build import INT, PTR

_ARGTYPES = {"unav_gemm_tc": [INT, PTR, PTR, PTR, PTR]}
SLICE = 32          # k summed from zero before it joins the total (TC_BK)
MAX_BATCH = 4       # products of one launch (GEMM_MAX_BATCH)


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


def tf32x3_matmul_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (batched as torch.matmul) as the kernels compute it: per
    32-deep slice of k, lo.hi + hi.lo, then + hi.hi, in fp32; the slices
    summed in order."""
    ah, al = tf32x3_split(a)
    bh, bl = tf32x3_split(b)
    out = None
    for k0 in range(0, a.shape[-1], SLICE):
        ka, kb = (..., slice(k0, k0 + SLICE)), (..., slice(k0, k0 + SLICE), slice(None))
        part = al[ka] @ bh[kb] + ah[ka] @ bl[kb]
        part = part + ah[ka] @ bh[kb]
        out = part if out is None else out + part
    return out


def conv3_taps(x: torch.Tensor, seq: int) -> torch.Tensor:
    """The k=3 "same" conv's operand as one product of depth 3*Kc: rows of
    x (M, Kc) are (sequence, t) with t = m % seq; row m of the result is
    [x[m-1], x[m], x[m+1]] with zeros outside the sequence (tap-major, as
    the kernel's loader reads it)."""
    r = x.reshape(-1, seq, x.shape[-1])
    left = F.pad(r[:, :-1], (0, 0, 1, 0))
    right = F.pad(r[:, 1:], (0, 0, 0, 1))
    return torch.cat([left, r, right], -1).reshape(x.shape[0], -1)


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


def _check(name, t, dims, dtype=torch.float32):
    if t.device.type != "cuda" or t.dtype != dtype or t.dim() != dims:
        raise ValueError(f"{name}: needs a {dims}-d {dtype} CUDA tensor, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def tf32x3_products(calls):
    """Run up to four products in one launch, as the MHCA and CSP kernels
    batch them. Each call is a dict of `tf32x3_linear`'s arguments (`x`,
    `w`, optional `bias`, `rowmask`, `scale`, `taps`, `seq`, `out`).
    Returns the outputs. CPU tensors take the plain version."""
    if not 1 <= len(calls) <= MAX_BATCH:
        raise ValueError(f"tf32x3_products: 1 to {MAX_BATCH} products, got {len(calls)}")
    if calls[0]["x"].device.type == "cpu":
        outs = []
        for c in calls:
            y = tf32x3_linear_reference(c["x"], c["w"], c.get("bias"), rowmask=c.get("rowmask"),
                                        scale=c.get("scale", 1.0), taps=c.get("taps", 1),
                                        seq=c.get("seq", 1))
            if c.get("out") is not None:
                c["out"].copy_(y)
                y = c["out"]
            outs.append(y)
        return outs
    ptrs, ints, scales, outs = [], [], [], []
    for c in calls:
        x, w, taps = c["x"], c["w"], c.get("taps", 1)
        _check("x", x, 2)
        _check("w", w, 2)
        m, kc = x.shape
        n, k = w.shape
        if taps not in (1, 3) or k != taps * kc or x.stride(1) != 1 or not w.is_contiguous():
            raise ValueError(f"tf32x3_products: x {tuple(x.shape)} (strides {x.stride()}), "
                             f"w {tuple(w.shape)}, taps {taps}")
        out = c.get("out")
        if out is None:
            out = torch.empty((m, n), device=x.device, dtype=torch.float32)
        _check("out", out, 2)
        if tuple(out.shape) != (m, n) or out.stride(1) != 1:
            raise ValueError(f"out: shape {tuple(out.shape)}, strides {out.stride()}")
        bias, rowmask = c.get("bias"), c.get("rowmask")
        if bias is not None:
            _check("bias", bias, 1)
        if rowmask is not None:
            _check("rowmask", rowmask, 1, torch.bool)
        # the kernel's ring copies 16-byte chunks of rows of x and w
        if (x.data_ptr() % 16 or w.data_ptr() % 16 or x.stride(0) % 4 or kc % 4 or n % 2
                or out.stride(0) % 2 or out.data_ptr() % 8):
            raise ValueError("tf32x3_products: x and w need 16-byte aligned rows "
                             "(strides and K multiples of 4 floats), N and out's row "
                             "stride even")
        ptrs += [x.data_ptr(), w.data_ptr(), out.data_ptr(),
                 bias.data_ptr() if bias is not None else None,
                 rowmask.data_ptr() if rowmask is not None else None]
        ints += [x.stride(0), k, out.stride(0), m, n, k, taps, c.get("seq", 1)]
        scales.append(float(c.get("scale", 1.0)))
        outs.append(out)
    lib = cuda_build.library("gemm_tc", _ARGTYPES)
    rc = lib.unav_gemm_tc(
        len(calls), (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_long * len(ints))(*ints),
        (ctypes.c_float * len(scales))(*scales),
        torch.cuda.current_stream(outs[0].device).cuda_stream)
    cuda_build.check(lib, rc, "tf32x3_products")
    tf32x3_linear.launches += 1
    return outs


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
