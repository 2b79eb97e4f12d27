"""The bf16 whole-block TransformerBlock kernels against another checkout's
build of them, on the same card: the same bits, and the times in turns.

    python -m unav_yolyolva_tpu_torch.tools.bf16_tblock_ab --parent DIR [--seed N]

DIR is a checkout (e.g. unpacked by `git archive` into `build/`) whose
`unav_yolyolva_tpu_torch/csrc/tblock_bf16.cu` and `tblock_bwd_bf16.cu` are
built beside this checkout's and bound to the same wrappers (as
tools/bf16_fwd_ab.py binds them). On chip_smoke.py's cases (the flagship
model's `backbone.self_att_V.0`, weights from --seed):
- `same tblock_bf16@64x224x512`: whether the forward (phase 15's served
  stem) gives the parent's bits, else how many values differ and by how
  much;
- `same tblock_bwd_bf16@8x224x512 <grad>`: each of the backward's 14
  outputs at phase 16's train shape against the parent's; for d(mult_a)
  and d(mult_m), whose fp32 sums over the frames may be taken in another
  order, also the largest relative difference and the largest difference
  over the largest value;
- `same mlp_product@fc1|fc2 <epilogue>`: this checkout's MLP product
  (ops/gemm_tc.py:mlp_product) against the forward product
  (bf16_products, the parent's design, built from this checkout) on the
  same operands: the fp32 sums and the epilogues;
- `ab ...` lines: the forward and the backward timed through the wrappers
  in turns (parent, change, change, parent; CUDA events, mean of 10 calls);
- `launches ...` lines, last (torch.profiler must not touch the times): the
  kernels one forward and one backward launch, parent against change, at
  these shapes and at tests/test_torch_port_gpu.py's (3, 40, 64).
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import torch

from ..ops import cuda_build
from .bf16_fwd_ab import bound_to, diff_text

LIBS = ("tblock_bf16", "tblock_bwd_bf16")
GRADS = ("dx", "d_mult_a", "d_mult_m", "lnw3", "lnb3", "dw", "lnw", "lnb", "w", "b", "w1",
         "b1", "w2", "b2")


def rel_diff(a, b) -> float:
    """The largest |a - b| / |b| over the values (|b| floored at 1e-30)."""
    return float(((a.double() - b.double()).abs() / b.double().abs().clamp(min=1e-30)).max())


def scaled_diff(a, b) -> float:
    """The largest |a - b| over the largest |b|."""
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp(min=1e-30))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="a checkout whose bf16 TBlock kernels are held beside this one's")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bf16_tblock_ab: no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    import chip_smoke as smoke

    from ..core import load_config, resolve_device
    from ..models import build_model
    from ..ops.fused_tblock import fused_tblock, tblock_backward
    from ..ops.gemm_tc import bf16_products, mlp_product
    from .nms_bench import cuda_ms

    dev = resolve_device("cuda")
    smi = smoke.nvidia_smi()
    cuda_build.build(LIBS + ("gemm_bf16",))
    cuda_build.build(LIBS, {n: args.parent.resolve() / "unav_yolyolva_tpu_torch" / "csrc"
                            / f"{n}.cu" for n in LIBS})
    gen = torch.Generator().manual_seed(args.seed + 1)
    bf = torch.bfloat16
    parent = lambda: bound_to(args.parent, LIBS)   # noqa: E731

    def ab(label, fn):
        times = {"parent": [], "change": []}
        for side in ("parent", "change", "change", "parent"):
            if side == "parent":
                with parent():
                    times[side].append(cuda_ms(fn, 10))
            else:
                times[side].append(cuda_ms(fn, 10))
        print(f"ab {label}: parent {times['parent'][0]:.4f} / {times['parent'][1]:.4f} ms, "
              f"change {times['change'][0]:.4f} / {times['change'][1]:.4f} ms [{smi}]",
              flush=True)

    model = build_model(load_config(str(root / "configs" / "avel_unav100_eval.yaml")),
                        device=dev, seed=args.seed)
    with torch.inference_mode():
        blk, a = smoke.tblock_case(model, "backbone.self_att_V.0", 64, 224, gen, dev)
        heads = blk.attn.n_head
        with parent():
            p = fused_tblock(*a, heads=heads, cdtype=bf)
        n = fused_tblock(*a, heads=heads, cdtype=bf)
        print(f"same tblock_bf16@64x224x512: {torch.equal(p, n)} ({diff_text(n, p)})",
              flush=True)
        ab("tblock_bf16@64x224x512", lambda: fused_tblock(*a, heads=heads, cdtype=bf))
    del model

    tcfg = load_config(str(root / "configs" / "avel_unav100.yaml"))
    b, t = tcfg["loader"]["batch_size"], tcfg["model"]["max_seq_len"]
    tmodel = build_model(tcfg, device=dev, seed=args.seed)
    blk, a = smoke.tblock_case(tmodel, "backbone.self_att_V.0", b, t, gen, dev)
    heads = blk.attn.n_head
    g = torch.randn(b, t, a[0].shape[-1], generator=gen).to(dev)
    label = f"tblock_bwd_bf16@{b}x{t}x512"
    with parent():
        pg = tblock_backward(*a, g=g, heads=heads, cdtype=bf)
    ng = tblock_backward(*a, g=g, heads=heads, cdtype=bf)
    again = tblock_backward(*a, g=g, heads=heads, cdtype=bf)
    print(f"same {label} on repeat: {all(torch.equal(u, v) for u, v in zip(ng, again))}",
          flush=True)
    for name, u, v in zip(GRADS, pg, ng):
        line = f"same {label} {name}: {torch.equal(u, v)} ({diff_text(v, u)}"
        if name.startswith("d_mult"):
            line += (f", largest relative difference {rel_diff(v, u):.3e}, largest difference "
                     f"over the largest value {scaled_diff(v, u):.3e}")
        print(line + ")", flush=True)
    ab(label, lambda: tblock_backward(*a, g=g, heads=heads, cdtype=bf))
    del tmodel
    big = (a, g, heads, label)

    r, c, hid = 64, 512, 2048
    m = r * t
    rowmask = torch.rand(m, generator=gen).to(dev) > 0.1
    seqmul = (1 + 0.3 * torch.randn(r, c, generator=gen)).to(dev)
    resid = torch.randn(m, c, generator=gen).to(dev)
    for name, n_out, k in (("fc1", hid, c), ("fc2", c, hid)):
        x = torch.randn(m, k, generator=gen).to(dev, bf)
        w = (torch.randn(n_out, k, generator=gen) / math.sqrt(k)).to(dev, bf)
        bias = (0.1 * torch.randn(n_out, generator=gen)).to(dev, bf)
        cases = {"raw": (dict(x=x, w=w, raw=True), dict(epi="raw"))}
        if name == "fc1":
            cases["gelu"] = (dict(x=x, w=w, bias=bias, act="gelu"), dict(epi="gelu", bias=bias))
        else:
            cases["res"] = (dict(x=x, w=w, bias=bias, rowmask=rowmask, seq=t, seqmul=seqmul,
                                 out=resid.clone()),
                            dict(epi="res", bias=bias, rowmask=rowmask, seq=t, seqmul=seqmul,
                                 out=resid.clone()))
        for epi, (old, new) in cases.items():
            u = bf16_products([old])[0]
            v = mlp_product(x, w, **new)
            print(f"same mlp_product@{name} {epi}: {torch.equal(u, v)} ({diff_text(v, u)})",
                  flush=True)

    def launches(label, fn):
        with parent():
            n_parent = smoke.kernel_launches(fn)
        print(f"launches {label}: parent {n_parent}, change {smoke.kernel_launches(fn)} "
              f"(torch.profiler, one call)", flush=True)

    a, g, heads, label = big
    launches(label, lambda: tblock_backward(*a, g=g, heads=heads, cdtype=bf))

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(dev)

    # tests/test_torch_port_gpu.py's small case: (3, 40, 64), 4 heads, hidden 256
    c = 64
    sa = [rnd(3, 40, c), torch.arange(40, device=dev)[None, :]
          < torch.tensor([40, 20, 0], device=dev)[:, None], 0.7 + rnd(3, 1, c, scale=0.3),
          1.3 + rnd(3, 1, c, scale=0.3), 1 + rnd(3, c, scale=0.1), rnd(3, c, scale=0.1),
          rnd(3, c, 3, scale=0.5), 1 + rnd(3, c, scale=0.1), rnd(3, c, scale=0.1),
          rnd(4, c, c, scale=c ** -0.5), rnd(4, c, scale=0.1), rnd(4 * c, c, scale=c ** -0.5),
          rnd(4 * c, scale=0.1), rnd(c, 4 * c, scale=0.5 / c), rnd(c, scale=0.1)]
    gs = rnd(3, 40, c)
    with torch.inference_mode():
        launches("tblock_bf16@3x40x64", lambda: fused_tblock(*sa, heads=4, cdtype=bf))
    launches("tblock_bwd_bf16@3x40x64",
             lambda: tblock_backward(*sa, g=gs, heads=4, cdtype=bf))
    return 0


if __name__ == "__main__":
    sys.exit(main())
