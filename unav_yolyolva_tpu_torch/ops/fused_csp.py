"""Fused MaxSigmoidCSPLayer forward: hand-written CUDA kernel sequence and
its plain version.

Replaces the Pallas kernel `_csp_kernel` (body `_csp_compute`,
unav_yolyolva_tpu/ops/pallas_csp.py:58-217): main 1x1 conv split in two,
three chained MaskedMHCA blocks, guide_fc over the guide tokens, per-head
max over tokens -> sigmoid gate on a k=3 projection conv, final 1x1 conv
over the concat [main0, main1, mhca0, mhca1, mhca2, gated].

On the card (csrc/csp.cu) it is bound by operations: at T=224, 2B=128 the
products are ~95% of its 16.7 GFLOP-per-layer share, and guide_fc alone is
7.5 GFLOP at every level. Every product (the four convs and the three
MHCAs' dense layers and attention) runs in 3xTF32 on the tensor cores
(csrc/gemm_tc.cuh, `ops/gemm_tc.py`), with a tile shape chosen per product
so that the small pyramid levels (T = 7, 14, 28) still fill the card; the
gate's max over guide tokens stays fp32 FFMA. The design writes each part
straight into its slice of one concat buffer (product epilogue with output
stride and column offset), runs guide_fc as one product over the whole
batch, and handles the ragged small levels by bounds checks instead of
padding.

The backward (`csp_backward`) replaces the Pallas kernel `_csp_bwd_kernel` /
`_csp_diff_bwd` (pallas_csp.py:243-391): it recomputes the layer once from
the inputs and weights, as the TPU kernel does, keeping each inner MHCA's
intermediates and the gate's max, tie count and argmax, and walks it in
reverse (csrc/csp_bwd.cu); the max over guide tokens routes its grad to the
argmax token(s), split evenly over ties. Every product of the backward
(the convs' and guide_fc's input and weight grads, the MHCAs' dense layers
and attention) runs in 3xTF32 on the tensor cores. On CUDA with grad
enabled, `fused_csp` runs through `CSPFunction`, whose backward is that
kernel.

Under the bf16 compute policy (bf16 x and guide) the layer is the JAX
package's bf16 program: every product's fp32 sum rounded to bf16 before
its bias is added in bf16, the three MHCAs in bf16 (`fused_mhca`), the
gate's scores summed in fp32 with its max and sigmoid in fp32, the gate
rounded to bf16 before it multiplies the bf16 projection. On the card it
is a launch sequence of its own (csrc/csp_bf16.cu on csrc/bf16.cuh, 17
launches): the products and the gate's scores on the bf16 tensor cores,
the weights cast to bf16 once per call. Its backward is the JAX package's
bf16 `_csp_bwd_kernel`, `jax.vjp` of the bf16 body once per block of the
TPU kernel's rows (T padded to 8): the plain version is autograd of the bf16
forward per block, with JAX's bf16 reduction and cotangent orders
(ops/bf16_grad.py); on the card csrc/csp_bwd_bf16.cu (the three MHCAs in
csrc/bf16_bwd.cuh's form MHCA_VJP, the gate rescored through the forward's
own scoring function, weight grads rounded to bf16 per row block).

Weight layout (torch): wmain (2mid, Cin), bmain (2mid); per MHCA block,
stacked over the 3 blocks: dw (3, 3, mid, 3), lnw/lnb (3, 3, mid),
w (3, 4, mid, mid), b (3, 4, mid); wg (emb, Fg), bg (emb), battn (H),
wproj (mid, mid, 3) [Conv1d layout], bproj (mid), wfinal (Cout, 6mid),
bfinal (Cout). emb == mid.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import cuda_build
from .cuda_build import FLOAT, INT, LONG, PTR
from .bf16_grad import broadcast_mul, fan_out, pick_rows_csp_bwd, row_blocks
from .fused_mhca import MAX_T, _check, mhca_input_uses, mhca_reference
from .gemm_tc import bf16_product_reference
from ..utils.profiling import spanned

_ARGTYPES = {"unav_csp_forward": [PTR] * 3 + [INT] * 9 + [PTR] * 14 + [FLOAT] + [PTR] * 5}
_BF16_ARGTYPES = {"unav_csp_bf16_forward": [PTR] * 3 + [INT] * 9 + [PTR] * 14 + [FLOAT]
                  + [PTR] * 3}
_BF16_RESTYPES = {"unav_csp_bf16_scratch": ([INT] * 7, LONG)}
_BWD_ARGTYPES = {"unav_csp_backward": [PTR] * 3 + [INT] * 9 + [PTR] * 15 + [FLOAT] + [PTR] * 19}
_BWD_RESTYPES = {"unav_csp_backward_scratch": ([INT] * 9, LONG)}
_BWD_BF16_ARGTYPES = {"unav_csp_bf16_backward": [PTR] * 3 + [INT] * 11 + [PTR] * 14 + [FLOAT]
                      + [PTR] * 19}
_BWD_BF16_RESTYPES = {"unav_csp_bf16_backward_scratch": ([INT] * 9, LONG)}


def csp_reference(x, guide, mask, wmain, bmain, dw, lnw, lnb, w, b, wg, bg,
                  battn, wproj, bproj, wfinal, bfinal, *, attn_heads: int,
                  mhca_heads: int = 4, eps: float = 1e-5, linear=F.linear,
                  matmul=torch.matmul) -> torch.Tensor:
    """Plain PyTorch version of the fused CSP layer, in the dtype of x and
    guide (fp32, or bf16 under the bf16 policy). `linear` computes the fp32
    convs and dense layers, `matmul` the MHCAs' attention products (the
    kernel's 3xTF32 rounding: ops/gemm_tc.py); in bf16 the products are
    `bf16_product_reference`. The k=3 projection conv is one product of depth
    3*mid, as the kernel runs it."""
    r, t, _ = x.shape
    mid = w.shape[-1]
    mm = mask[..., None].to(x.dtype)
    if x.dtype != torch.float32:
        linear = bf16_product_reference
    y = linear(x, wmain, bmain) * mm
    parts = [y[..., :mid], y[..., mid:]]
    for bi in range(3):
        uses = None
        if x.dtype == torch.bfloat16:   # the concat's grad first, then the MHCA's
            parts[-1], *uses = mhca_input_uses(parts[-1], parts[-1], lead=1)
        parts.append(mhca_reference(parts[-1], parts[-1], mask, dw[bi], lnw[bi],
                                    lnb[bi], w[bi], b[bi], heads=mhca_heads, eps=eps,
                                    linear=linear, matmul=matmul, uses=uses))
    # p's grads add as the JAX program adds them: the concat's, the gate
    # scores', then the projection conv's centre, right and left taps
    parts[-1], p_sc, p_c, p_r, p_l = fan_out(parts[-1], 5)
    gp = linear(guide, wg, bg)                                    # (R, Ng, emb)
    taps = torch.cat([F.pad(p_l[:, :-1], (0, 0, 1, 0)), p_c, F.pad(p_r[:, 1:], (0, 0, 0, 1))],
                     -1).reshape(r * t, 3 * mid)                  # conv3_taps: (R*T, 3 mid)
    wtaps = wproj.permute(0, 2, 1).reshape(mid, 3 * mid)          # [out, tap, in]
    pc = linear(taps, wtaps, bproj).reshape(r, t, mid) * mm
    parts.append(gate_reference(p_sc, gp, pc, battn, attn_heads=attn_heads))
    return linear(torch.cat(parts, dim=-1), wfinal, bfinal) * mm


def gate_reference(p, gp, pc, battn, *, attn_heads: int) -> torch.Tensor:
    """The CSP layer's max-sigmoid gate in plain PyTorch: per head h, the
    scores p_h gp_h^T of p (R, T, emb) and the projected guide gp (R, Ng,
    emb) summed in fp32 (the products of bf16 values are exact there), their
    max over the Ng tokens / sqrt(hc), sigmoid(+ battn[h]) in fp32, cast to
    pc's dtype, times the head's channels of pc (R, T, mid). Autograd splits
    the max's grad over tied tokens evenly, as JAX's max does."""
    r, t, mid = pc.shape
    hc = gp.shape[-1] // attn_heads
    sc = torch.einsum("rthc,rnhc->rhtn", p.float().reshape(r, t, attn_heads, hc),
                      gp.float().reshape(r, -1, attn_heads, hc))  # fp32 sums
    mx = sc.amax(dim=-1) / math.sqrt(hc)                          # (R, H, T)
    gate = torch.sigmoid(mx + battn[None, :, None]).transpose(1, 2).to(pc.dtype)
    gated = broadcast_mul(pc.reshape(r, t, attn_heads, -1), gate[..., None])
    return gated.reshape(r, t, mid)


def _csp_grads(x, guide, mask, g, *weights, attn_heads, mhca_heads, eps):
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (x, guide, *weights)]
        out = csp_reference(ins[0], ins[1], mask, *ins[2:], attn_heads=attn_heads,
                            mhca_heads=mhca_heads, eps=eps)
        return torch.autograd.grad(out, ins, g)


def csp_backward_rows(x, guide, mask, *weights, attn_heads: int, mhca_heads: int = 4) -> int:
    """The batch block R of the JAX bf16 backward kernel for these inputs
    (`pick_rows_csp_bwd` at T padded to a multiple of 8 and the itemsize of
    x, as the JAX kernel reads them)."""
    r, t, cin = x.shape
    mid = weights[5].shape[-1]
    return pick_rows_csp_bwd(r, -(-t // 8) * 8, cin, mid, guide.shape[1], guide.shape[2],
                             weights[7].shape[0], weights[12].shape[0], x.element_size(),
                             attn_heads, mhca_heads)


def csp_backward_reference(x, guide, mask, *weights, g, attn_heads: int,
                           mhca_heads: int = 4, eps: float = 1e-5):
    """Plain version of the backward: (dx, dguide, grad of each of the 14
    weights), torch.autograd.grad of `csp_reference` for the upstream grad
    g. For bf16 x, guide and g, the JAX package's bf16 backward kernel: T
    padded to a multiple of 8 (zero rows, masked), the grads taken once per
    block of `csp_backward_rows` rows, each block's bf16 weight grads added
    in fp32 (ops/bf16_grad.py)."""
    if x.dtype != torch.bfloat16:
        return _csp_grads(x, guide, mask, g, *weights, attn_heads=attn_heads,
                          mhca_heads=mhca_heads, eps=eps)
    t = x.shape[1]
    pad = -t % 8
    rows = csp_backward_rows(x, guide, mask, *weights, attn_heads=attn_heads,
                             mhca_heads=mhca_heads)
    xp, maskp, gpd = (F.pad(x, (0, 0, 0, pad)), F.pad(mask, (0, pad)),
                      F.pad(g, (0, 0, 0, pad)))

    def block(xb, gdb, mb, gb, *ws):
        return _csp_grads(xb, gdb, mb, gb, *ws, attn_heads=attn_heads,
                          mhca_heads=mhca_heads, eps=eps)

    dx, *rest = row_blocks(block, rows, (xp, guide, maskp, gpd), weights, 2)
    return (dx[:, :t], *rest)


def _check_args(x, guide, mask, wmain, bmain, dw, lnw, lnb, w, b, wg, bg, battn,
                wproj, bproj, wfinal, bfinal, attn_heads, mhca_heads):
    r, t, cin = x.shape
    _, ng, fg = guide.shape
    mid, cout = w.shape[-1], wfinal.shape[0]
    # the products copy rows of 16 bytes: Cin, Fg and the MHCA head width
    # (so mid) multiples of 4 floats (8 bf16), Cout even
    q = 16 // x.element_size()
    if (mid % attn_heads or mid % mhca_heads or (mid // mhca_heads) % q
            or mid // mhca_heads > 128 or mid // attn_heads > 128 or mid > 1024
            or cin % q or fg % q or cout % 2 or t > MAX_T or wg.shape[0] != mid
            or x.dtype not in (torch.float32, torch.bfloat16)):
        raise ValueError(f"fused_csp: unsupported shape (T={t}, Cin={cin}, mid={mid}, "
                         f"Fg={fg}, Cout={cout}, heads={attn_heads}/{mhca_heads}, "
                         f"emb={wg.shape[0]}, {x.dtype})")
    _check(x, "x", dtype=x.dtype)
    _check(guide, "guide", (r, ng, fg), x.dtype)
    for name, ten, shape in (
        ("wmain", wmain, (2 * mid, cin)),
        ("bmain", bmain, (2 * mid,)), ("dw", dw, (3, 3, mid, 3)), ("lnw", lnw, (3, 3, mid)),
        ("lnb", lnb, (3, 3, mid)), ("w", w, (3, 4, mid, mid)), ("b", b, (3, 4, mid)),
        ("wg", wg, (mid, fg)), ("bg", bg, (mid,)), ("battn", battn, (attn_heads,)),
        ("wproj", wproj, (mid, mid, 3)), ("bproj", bproj, (mid,)),
        ("wfinal", wfinal, (cout, 6 * mid)), ("bfinal", bfinal, (cout,)),
    ):
        _check(ten, name, shape)
    _check(mask, "mask", (r, t), torch.bool)
    return r, t, cin, mid, ng, fg, cout


def _launch_forward(x, guide, mask, wmain, bmain, dw, lnw, lnb, w, b, wg, bg, battn, wproj,
                    bproj, wfinal, bfinal, attn_heads, mhca_heads, eps):
    r, t, cin, mid, ng, fg, cout = _check_args(
        x, guide, mask, wmain, bmain, dw, lnw, lnb, w, b, wg, bg, battn, wproj, bproj,
        wfinal, bfinal, attn_heads, mhca_heads)
    wproj = wproj.permute(0, 2, 1).contiguous()                   # (mid, 3, mid)
    dev = x.device
    out = torch.empty((r, t, cout), device=dev, dtype=torch.float32)
    cat = torch.empty(r * t * 6 * mid, device=dev, dtype=torch.float32)
    gp = torch.empty(r * ng * mid, device=dev, dtype=torch.float32)
    scratch = torch.empty(6 * r * t * mid, device=dev, dtype=torch.float32)
    lib = cuda_build.library("csp", _ARGTYPES)
    rc = lib.unav_csp_forward(
        x.data_ptr(), guide.data_ptr(), mask.data_ptr(), r, t, cin, mid, ng, fg,
        cout, attn_heads, mhca_heads,
        wmain.data_ptr(), bmain.data_ptr(), dw.data_ptr(), lnw.data_ptr(),
        lnb.data_ptr(), w.data_ptr(), b.data_ptr(), wg.data_ptr(), bg.data_ptr(),
        battn.data_ptr(), wproj.data_ptr(), bproj.data_ptr(), wfinal.data_ptr(),
        bfinal.data_ptr(), eps, out.data_ptr(), cat.data_ptr(), gp.data_ptr(),
        scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    cuda_build.check(lib, rc, "unav_csp_forward")
    return out


def _launch_forward_bf16(x, guide, mask, wmain, bmain, dw, lnw, lnb, w, b, wg, bg, battn,
                         wproj, bproj, wfinal, bfinal, attn_heads, mhca_heads, eps, *,
                         keep=None):
    """The bf16 forward's C entry; `keep`, a list, gets the call's scratch
    (the (R*T, 6 mid) bf16 concat at its start)."""
    r, t, cin, mid, ng, fg, cout = _check_args(
        x, guide, mask, wmain, bmain, dw, lnw, lnb, w, b, wg, bg, battn, wproj, bproj,
        wfinal, bfinal, attn_heads, mhca_heads)
    out = torch.empty((r, t, cout), device=x.device, dtype=torch.bfloat16)
    lib = cuda_build.library("csp_bf16", _BF16_ARGTYPES, _BF16_RESTYPES)
    scratch = torch.empty(lib.unav_csp_bf16_scratch(r, t, cin, mid, ng, fg, cout),
                          device=x.device, dtype=torch.bfloat16)
    rc = lib.unav_csp_bf16_forward(
        x.data_ptr(), guide.data_ptr(), mask.data_ptr(), r, t, cin, mid, ng, fg,
        cout, attn_heads, mhca_heads,
        *[a.data_ptr() for a in (wmain, bmain, dw, lnw, lnb, w, b, wg, bg, battn, wproj,
                                 bproj, wfinal, bfinal)],
        eps, out.data_ptr(), scratch.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, rc, "unav_csp_bf16_forward")
    if keep is not None:
        keep.append(scratch)
    return out


def _forward_kernel(*args):
    if args[0].dtype == torch.bfloat16:
        out = _launch_forward_bf16(*args)
        fused_csp.bf16_launches += 1
        return out
    out = _launch_forward(*args)
    fused_csp.launches += 1
    return out


def _launch_backward(x, guide, mask, *weights, g, attn_heads, mhca_heads, eps):
    r, t, cin, mid, ng, fg, cout = _check_args(x, guide, mask, *weights, attn_heads,
                                               mhca_heads)
    if cout % 4:      # the final conv's grads copy rows of g in 16-byte chunks
        raise ValueError(f"csp_backward: Cout={cout} is not a multiple of 4")
    _check(g, "g", (r, t, cout))
    wproj = weights[10]
    wproj_k = wproj.permute(0, 2, 1).contiguous()                 # (mid, 3, mid)
    wproj_t = wproj.permute(2, 0, 1).contiguous()                 # (3, mid, mid)
    ws = list(weights[:10]) + [wproj_k, wproj_t] + list(weights[11:])
    grads = [torch.empty_like(a) for a in (x, guide, *weights[:10], wproj_k, *weights[11:])]
    lib = cuda_build.library("csp_bwd", _BWD_ARGTYPES, _BWD_RESTYPES)
    scratch = torch.empty(lib.unav_csp_backward_scratch(r, t, cin, mid, ng, fg, cout,
                                                        attn_heads, mhca_heads),
                          device=x.device, dtype=torch.float32)
    rc = lib.unav_csp_backward(
        x.data_ptr(), guide.data_ptr(), mask.data_ptr(), r, t, cin, mid, ng, fg, cout,
        attn_heads, mhca_heads, *[a.data_ptr() for a in ws], eps, g.data_ptr(),
        *[a.data_ptr() for a in grads], scratch.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_build.check(lib, rc, "unav_csp_backward")
    grads[12] = grads[12].permute(0, 2, 1).contiguous()          # -> (mid, mid, 3)
    return tuple(grads)


def _prepare_backward_bf16(x, guide, mask, *weights, g, attn_heads, mhca_heads, eps):
    """The bf16 backward's host work before its C entry: the checks, the row
    block, the grads (each in its input's layout: the kernel reads and writes
    Wproj as the layer keeps it) and the scratch. Returns (lib, the entry's
    arguments, grads, scratch)."""
    r, t, cin, mid, ng, fg, cout = _check_args(x, guide, mask, *weights, attn_heads,
                                               mhca_heads)
    _check(g, "g", (r, t, cout), torch.bfloat16)
    rows = csp_backward_rows(x, guide, mask, *weights, attn_heads=attn_heads,
                             mhca_heads=mhca_heads)
    grads = [torch.empty_like(a) for a in (x, guide, *weights)]
    lib = cuda_build.library("csp_bwd_bf16", _BWD_BF16_ARGTYPES, _BWD_BF16_RESTYPES)
    scratch = torch.empty(lib.unav_csp_bf16_backward_scratch(r, t, cin, mid, ng, fg, cout,
                                                             attn_heads, mhca_heads),
                          device=x.device, dtype=torch.float32)
    args = (x.data_ptr(), guide.data_ptr(), mask.data_ptr(), r, t, cin, mid, ng, fg, cout,
            attn_heads, mhca_heads, rows, -(-t // 8) * 8, *[a.data_ptr() for a in weights],
            eps, g.data_ptr(), *[a.data_ptr() for a in grads], scratch.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    return lib, args, grads, scratch


def _launch_backward_bf16(x, guide, mask, *weights, g, attn_heads, mhca_heads, eps):
    lib, args, grads, _ = _prepare_backward_bf16(x, guide, mask, *weights, g=g,
                                                 attn_heads=attn_heads,
                                                 mhca_heads=mhca_heads, eps=eps)
    cuda_build.check(lib, lib.unav_csp_bf16_backward(*args), "csp_backward (bf16)")
    return tuple(grads)


@spanned("unav.kernel.csp_backward")
def csp_backward(x, guide, mask, *weights, g, attn_heads: int, mhca_heads: int = 4,
                 eps: float = 1e-5):
    """Grads of the CSP layer forward for the upstream grad g (R, T, Cout):
    (dx, dguide, grad of each of the 14 weights), each in its input's layout
    (wproj's as (mid, mid, 3)). CPU tensors take the plain version; CUDA
    tensors launch the kernel of x's dtype."""
    if x.device.type == "cpu":
        return csp_backward_reference(x, guide, mask, *weights, g=g, attn_heads=attn_heads,
                                      mhca_heads=mhca_heads, eps=eps)
    if x.dtype == torch.bfloat16:
        grads = _launch_backward_bf16(x, guide, mask, *weights, g=g, attn_heads=attn_heads,
                                      mhca_heads=mhca_heads, eps=eps)
        csp_backward.bf16_launches += 1
        return grads
    grads = _launch_backward(x, guide, mask, *weights, g=g, attn_heads=attn_heads,
                             mhca_heads=mhca_heads, eps=eps)
    csp_backward.launches += 1
    return grads


class CSPFunction(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient. Like the
    JAX custom_vjp it saves only the inputs and weights; the mask gets no
    grad."""

    @staticmethod
    def forward(ctx, x, guide, mask, *rest):
        *weights, attn_heads, mhca_heads, eps = rest
        ctx.save_for_backward(x, guide, mask, *weights)
        ctx.heads = (attn_heads, mhca_heads, eps)
        if x.device.type == "cpu":
            return csp_reference(x, guide, mask, *weights, attn_heads=attn_heads,
                                 mhca_heads=mhca_heads, eps=eps)
        return _forward_kernel(x, guide, mask, *weights, attn_heads, mhca_heads, eps)

    @staticmethod
    def backward(ctx, g):
        x, guide, mask, *weights = ctx.saved_tensors
        attn_heads, mhca_heads, eps = ctx.heads
        dx, dguide, *gws = csp_backward(x, guide, mask, *weights, g=g.contiguous(),
                                        attn_heads=attn_heads, mhca_heads=mhca_heads,
                                        eps=eps)
        return (dx, dguide, None, *gws, None, None, None)


@spanned("unav.kernel.csp")
def fused_csp(x, guide, mask, wmain, bmain, dw, lnw, lnb, w, b, wg, bg, battn,
              wproj, bproj, wfinal, bfinal, *, attn_heads: int,
              mhca_heads: int = 4, eps: float = 1e-5) -> torch.Tensor:
    """CSP layer forward of x (R, T, Cin) guided by (R, Ng, Fg) tokens (both
    fp32, or both bf16 under the bf16 policy; weights fp32), with a (R, T)
    bool mask, in x's dtype. CPU tensors take the plain version; CUDA
    tensors launch the kernel sequence of their dtype. When a grad is needed
    the call goes through CSPFunction, whose backward is the backward kernel
    of the dtype (on the CPU its plain version, by row blocks in bf16), but
    for fp32 CPU tensors, where autograd differentiates the plain forward."""
    args = (x, guide, mask, wmain, bmain, dw, lnw, lnb, w, b, wg, bg, battn,
            wproj, bproj, wfinal, bfinal)
    grad = torch.is_grad_enabled() and any(a.requires_grad for a in args)
    if x.device.type == "cpu" and not (grad and x.dtype == torch.bfloat16):
        return csp_reference(*args, attn_heads=attn_heads, mhca_heads=mhca_heads,
                             eps=eps)
    if grad:
        return CSPFunction.apply(*args, attn_heads, mhca_heads, eps)
    return _forward_kernel(*args, attn_heads, mhca_heads, eps)


fused_csp.launches = 0
fused_csp.bf16_launches = 0
csp_backward.launches = 0
csp_backward.bf16_launches = 0
