"""The yardstick of a kernel's roofline: the calls of the program's kernel
entry points that one step makes, counted from the configuration, each
call's algorithmic work (its products' FLOPs and the bytes of reading each
input once and writing each output once), and the card's peaks.

The FLOPs are of the products alone: the dense layers, the attention's two
products, the convolutions as products over their taps, and the CSP gate's
scores. Depthwise convolutions, norms, softmax, activations and NMS count
none, so no correct implementation can read above its bound and a rewrite
of the kernel does not move its work. A backward's products are twice its
forward's (each product's input and weight gradients); its recompute is the
implementation's, not the algorithm's, and does not count. The shape
arithmetic is that of the program's chip_smoke.py (mhca_products,
csp_products), frozen here; the CSP count adds the gate's scores, which
chip_smoke.py left to FFMA.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List

# Published peaks of one NVIDIA H100 SXM (80 GB HBM3) at its 700 W limit,
# dense: products of bf16 inputs on the tensor cores, of fp32 inputs at the
# TF32 rate (the fastest any product of fp32 inputs runs on the card), HBM.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BF16 = 989e12          # the model-FLOP utilization's peak, whatever the dtype
PEAK_BYTES = 3.35e12

ES = {"bfloat16": 2, "float32": 4}


@dataclass(frozen=True)
class Call:
    entry: str      # mhca, csp, nms, mhca_backward, csp_backward
    shape: tuple    # the entry's shape arguments (see `work`)
    dtype: str      # the activations' dtype
    count: int      # calls of this shape in one step


def mhca_products(r, t, c):
    """q/k/v/proj dense layers and the attention's QK^T and PV."""
    return 8 * r * t * c * c + 4 * r * t * t * c


def mhca_weight_elems(c):
    return 3 * c * 3 + 2 * 3 * c + 4 * c * c + 4 * c


def csp_products(r, t, cin, mid, ng, fg, cout):
    """chip_smoke.py's csp_products (the main conv, three MHCAs, guide_fc, the
    k=3 projection conv, the final conv) plus the gate's scores."""
    return (2 * r * t * cin * 2 * mid + 3 * mhca_products(r, t, mid) + 2 * r * ng * fg * mid
            + 2 * r * t * mid * ng + 2 * r * t * 3 * mid * mid + 2 * r * t * 6 * mid * cout)


def csp_weight_elems(cin, mid, fg, heads, cout):
    return (2 * mid * cin + 2 * mid + 3 * mhca_weight_elems(mid) + mid * fg + mid + heads
            + 3 * mid * mid + mid + cout * 6 * mid + cout)


def work(call: Call):
    """(product FLOPs, bytes) of one call."""
    es = ES[call.dtype]
    if call.entry in ("mhca", "mhca_backward"):
        r, t, c, _heads = call.shape
        acts, w = 2 * r * t * c * es + r * t, mhca_weight_elems(c) * 4
        if call.entry == "mhca":
            return mhca_products(r, t, c), acts + w + r * t * c * es
        # reads x1, x2, mask, weights and g; writes dx1, dx2 and fp32 weight grads
        return 2 * mhca_products(r, t, c), acts + w + 3 * r * t * c * es + w
    if call.entry in ("csp", "csp_backward"):
        r, t, cin, mid, ng, fg, cout, heads = call.shape
        acts = r * t * cin * es + r * ng * fg * es + r * t
        w = csp_weight_elems(cin, mid, fg, heads, cout) * 4
        flops = csp_products(r, t, cin, mid, ng, fg, cout)
        if call.entry == "csp":
            return flops, acts + w + r * t * cout * es
        return 2 * flops, 2 * acts - r * t + w + r * t * cout * es + w
    if call.entry == "nms":
        g, n, m = call.shape
        return 0, g * n * (2 * 4 + 4 + 4) + g * m * (4 + 4)
    raise ValueError(f"unknown entry {call.entry}")


def least_seconds(call: Call) -> float:
    """The least time of one call: the larger of its products over the peak of
    its inputs' dtype and its bytes over the HBM bandwidth."""
    flops, nbytes = work(call)
    return max(flops / PEAK_FLOPS[call.dtype], nbytes / PEAK_BYTES)


def step_calls(cfg: Dict, batch: int, train: bool) -> List[Call]:
    """Every kernel entry point call of one step of `batch` videos at `cfg`:
    the stem's MHCAs, the fusion's text enhancer and ten CSP layers with the
    program's fixed heads (models/fusion.py: top-down [8, 4, 4, 4, 4],
    bottom-up 8, each CSP's MHCAs 4); the eval step's multiclass Soft-NMS
    scan over every level's top-k candidates, or the top
    `tpu.nms_max_candidates` of them where that cuts; in training each
    forward call's backward, and no NMS. A configuration whose step calls
    other entry points raises rather than be counted wrong: the dependency
    block, the whole-block TransformerBlock stem (UNAV_FUSED_TBLOCK=always),
    NMS other than multiclass Soft-NMS."""
    m, test, tpu = cfg["model"], cfg["test_cfg"], cfg["tpu"]
    if m.get("use_dependency"):
        raise NotImplementedError("step_calls does not count the dependency block's calls")
    if os.environ.get("UNAV_FUSED_TBLOCK", "auto") == "always":
        raise NotImplementedError("step_calls does not count the whole-block TransformerBlock")
    if not train and (not test["multiclass_nms"] or test["nms_method"] != "soft"):
        raise NotImplementedError(f"step_calls counts multiclass Soft-NMS only, not "
                                  f"{test['nms_method']} (multiclass {test['multiclass_nms']})")
    dt = tpu["compute_dtype"]
    t, c, classes = m["max_seq_len"], m["embd_dim"], m["num_classes"]
    arch, r = m["backbone_arch"], 2 * batch
    levels = arch[2] + 1
    mid = c // 2
    calls = [Call("mhca", (batch, t, c, m["n_head"]), dt, 2 * (arch[1] - 1)),
             Call("mhca", (r, t, c, 4), dt, 1)]
    td_heads = [8, 4, 4, 4, 4][:levels - 1]
    for idx in range(levels - 1, 0, -1):
        calls.append(Call("csp", (r, t >> (idx - 1), 2 * c, mid, c, t, c,
                                  td_heads[levels - 1 - idx]), dt, 1))
    for idx in range(levels - 1):
        calls.append(Call("csp", (r, t >> (idx + 1), 2 * c, mid, c, t, c, 8), dt, 1))
    if train:
        calls += [Call(k.entry + "_backward", k.shape, k.dtype, k.count) for k in list(calls)]
    else:
        n = sum(min(test["pre_nms_topk"], (t >> lv) * classes) for lv in range(levels))
        cap = int(tpu.get("nms_max_candidates", 0))
        if 0 < cap < n:
            n = cap
        calls.append(Call("nms", (batch, n, min(test["max_seg_num"], n)), "float32", 1))
    return calls
