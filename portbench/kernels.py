"""Each kernel entry point of a step timed alone on the card, warm, with CUDA
events, at the shapes of the step's calls (work.step_calls), on random
inputs and weights of those shapes (a kernel's time does not depend on the
weights' values; the Soft-NMS scan's inputs are random candidates, all
valid)."""

from __future__ import annotations

from typing import List, Tuple

import torch

from .work import Call

DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _mask(gen, r, t, dev):
    lengths = torch.randint(1, t + 1, (r,), generator=gen, device=dev)
    lengths[0] = t
    return torch.arange(t, device=dev)[None, :] < lengths[:, None]


def _mhca_weights(gen, c, dev, lead=()):
    def rnd(*s, scale=1.0):
        return torch.randn(*lead, *s, generator=gen, device=dev) * scale
    return (rnd(3, c, 3, scale=0.3), 1.0 + rnd(3, c, scale=0.1), rnd(3, c, scale=0.1),
            rnd(4, c, c, scale=c ** -0.5), rnd(4, c, scale=0.02))


def _runner(call: Call, gen, dev):
    """A function that launches the call once."""
    from unav_yolyolva_tpu_torch.ops.fused_csp import csp_backward, fused_csp
    from unav_yolyolva_tpu_torch.ops.fused_mhca import fused_mhca, mhca_backward
    from unav_yolyolva_tpu_torch.ops.fused_nms import multiclass_soft_nms

    dt = DT[call.dtype]
    if call.entry in ("mhca", "mhca_backward"):
        r, t, c, heads = call.shape
        x1, x2, g = (torch.randn(r, t, c, generator=gen, device=dev).to(dt) for _ in range(3))
        args = (x1, x2, _mask(gen, r, t, dev), *_mhca_weights(gen, c, dev))
        if call.entry == "mhca":
            return lambda: fused_mhca(*args, heads=heads)
        return lambda: mhca_backward(*args, g, heads=heads)
    if call.entry in ("csp", "csp_backward"):
        r, t, cin, mid, ng, fg, cout, heads = call.shape
        x = torch.randn(r, t, cin, generator=gen, device=dev).to(dt)
        guide = torch.randn(r, ng, fg, generator=gen, device=dev).to(dt)
        g = torch.randn(r, t, cout, generator=gen, device=dev).to(dt)

        def rnd(*s, scale):
            return torch.randn(*s, generator=gen, device=dev) * scale
        ws = (rnd(2 * mid, cin, scale=cin ** -0.5), rnd(2 * mid, scale=0.02),
              *_mhca_weights(gen, mid, dev, lead=(3,)),
              rnd(mid, fg, scale=fg ** -0.5), rnd(mid, scale=0.02), rnd(heads, scale=0.1),
              rnd(mid, mid, 3, scale=(3 * mid) ** -0.5), rnd(mid, scale=0.02),
              rnd(cout, 6 * mid, scale=(6 * mid) ** -0.5), rnd(cout, scale=0.02))
        mask = _mask(gen, r, t, dev)
        if call.entry == "csp":
            return lambda: fused_csp(x, guide, mask, *ws, attn_heads=heads, mhca_heads=4)
        return lambda: csp_backward(x, guide, mask, *ws, g=g, attn_heads=heads, mhca_heads=4)
    if call.entry == "nms":
        rows, n, m = call.shape
        start = torch.rand(rows, n, generator=gen, device=dev) * 200
        segs = torch.stack([start, start + 1 + torch.rand(rows, n, generator=gen, device=dev)
                            * 60], -1)
        scores = torch.rand(rows, n, generator=gen, device=dev)
        cls = torch.randint(0, 100, (rows, n), generator=gen, device=dev, dtype=torch.int32)
        return lambda: multiclass_soft_nms(segs, scores, cls, max_out=m, sigma=0.4,
                                           min_score=0.001)
    raise ValueError(f"unknown entry {call.entry}")


@torch.no_grad()
def time_alone(calls: List[Call], dev, seed: int, launches: int = 10
               ) -> List[Tuple[Call, float]]:
    """[(call, seconds a launch)] for each distinct call."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for call in calls:
        run = _runner(call, gen, dev)
        for _ in range(2):
            run()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(launches):
            run()
        end.record()
        torch.cuda.synchronize(dev)
        out.append((call, start.elapsed_time(end) / 1e3 / launches))
        del run
    return out
