"""The bf16 forward kernels against another checkout's build of them, on the
same card: the same bits, and the times in turns.

    python -m unav_yolyolva_tpu_torch.tools.bf16_fwd_ab --parent DIR [--seed N]

DIR is a checkout (e.g. unpacked by `git archive` into `build/`) whose
`unav_yolyolva_tpu_torch/csrc/{mhca,csp,tblock,gemm}_bf16.cu` are built
beside this checkout's and bound to the same wrappers (`cuda_build.library`
pointed at DIR's sources while the parent runs). On phase 15's shapes
(chip_smoke.py's cases on the flagship model of
configs/avel_unav100_eval.yaml, weights from --seed):
- `same ...` lines: whether the bf16 MHCA (64, 224, 512) and (128, 224,
  256) and the whole-block TBlock (64, 224, 512) forwards give the
  parent's bits, and every product alone (the final conv, q/k/v three in a
  launch, the projection conv's taps, the bias + GELU + scale and the
  residual-tail epilogues, the raw fp32 sums);
- `diff csp_bf16@...` lines: the CSP forward at T=224 (4 and 8 heads) and
  T=7 (8 heads), its concat's slices 0-4 (main conv, the three MHCAs)
  against the parent's, the gated slice 5 and the output: how many values
  differ and by how much;
- `ab ...` lines: each forward timed through the wrappers in turns (parent,
  change, change, parent; CUDA events, mean of 10 calls). The parent's CSP
  entry took Wproj permuted to (mid, 3, mid), which its wrapper copied
  each call; the tool hands it that layout made once, so the parent's CSP
  time here leaves that copy out.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import math
import sys
from pathlib import Path

import torch

from ..ops import cuda_build

LIBS = ("mhca_bf16", "csp_bf16", "tblock_bf16", "gemm_bf16")
_parent_libs = {}   # name: the parent's library, bound once


@contextlib.contextmanager
def bound_to(parent: Path, libs=LIBS):
    """While open, the wrappers' libraries in `libs` come from `parent`'s
    sources (entry points it lacks are left unbound)."""
    orig = cuda_build.library
    csrc = parent.resolve() / "unav_yolyolva_tpu_torch" / "csrc"

    def library(name, argtypes, restypes=None, source=None):
        if source is not None or name not in libs:
            return orig(name, argtypes, restypes, source)
        if name not in _parent_libs:
            src = csrc / f"{name}.cu"
            cuda_build.build([name], {name: src})
            raw = ctypes.CDLL(str(cuda_build.library_path(name, src)))
            _parent_libs[name] = orig(
                name, {f: t for f, t in argtypes.items() if hasattr(raw, f)},
                {f: t for f, t in (restypes or {}).items() if hasattr(raw, f)}, src)
        return _parent_libs[name]

    cuda_build.library = library
    try:
        yield
    finally:
        cuda_build.library = orig


def diff_text(a, b) -> str:
    """How many values of a and b differ, and the largest difference."""
    d = a.float() != b.float()
    n = int(d.sum())
    big = float((a.float() - b.float()).abs().max()) if n else 0.0
    return f"{n} of {a.numel()} values differ (max abs {big:.3e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="a checkout whose bf16 forward kernels are held beside this one's")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bf16_fwd_ab: no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    import chip_smoke as smoke

    from ..core import load_config, resolve_device
    from ..models import build_model
    from ..ops.fused_csp import _launch_forward_bf16, fused_csp
    from ..ops.fused_mhca import fused_mhca
    from ..ops.fused_tblock import fused_tblock
    from ..ops.gemm_tc import bf16_products
    from .nms_bench import cuda_ms

    dev = resolve_device("cuda")
    smi = smoke.nvidia_smi()
    cuda_build.build(LIBS)
    cuda_build.build(LIBS, {n: args.parent.resolve() / "unav_yolyolva_tpu_torch" / "csrc"
                            / f"{n}.cu" for n in LIBS})
    gen = torch.Generator().manual_seed(args.seed + 1)
    model = build_model(load_config(str(root / "configs" / "avel_unav100_eval.yaml")),
                        device=dev, seed=args.seed)
    bf = torch.bfloat16

    def both(fn):
        """fn's outputs with the parent's build, then with this one's."""
        with bound_to(args.parent):
            p = fn()
        return p, fn()

    def ab(label, fn, parent_fn=None):
        times = {"parent": [], "change": []}
        for side in ("parent", "change", "change", "parent"):
            if side == "parent":
                with bound_to(args.parent):
                    times[side].append(cuda_ms(parent_fn or fn, 10))
            else:
                times[side].append(cuda_ms(fn, 10))
        print(f"ab {label}: parent {times['parent'][0]:.4f} / {times['parent'][1]:.4f} ms, "
              f"change {times['change'][0]:.4f} / {times['change'][1]:.4f} ms [{smi}]",
              flush=True)

    with torch.inference_mode():
        for label, key, r, c in (("mhca_bf16@64x224x512", "backbone.self_att_V.0.attn", 64, 512),
                                 ("mhca_bf16@128x224x256",
                                  "backbone.fusion_module.top_down_layers.4.blocks.0", 128, 256)):
            a = smoke.mhca_case(model, key, r, 224, c, gen, dev)
            heads = dict(model.named_modules())[key].n_head
            ab_args = (a[0].to(bf), a[1].to(bf), *a[2:])
            p, n = both(lambda: fused_mhca(*ab_args, heads=heads))
            print(f"same {label}: {torch.equal(p, n)} ({diff_text(n, p)})", flush=True)
            ab(label, lambda: fused_mhca(*ab_args, heads=heads))

        fusion = "backbone.fusion_module."
        for label, key, t in (("csp_bf16@T224/4h", fusion + "top_down_layers.4", 224),
                              ("csp_bf16@T224/8h", fusion + "bottom_up_layers.0", 224),
                              ("csp_bf16@T7/8h", fusion + "bottom_up_layers.4", 7)):
            a, heads = smoke.csp_case(model, key, 128, t, gen, dev)
            cargs = (a[0].to(bf), a[1].to(bf), *a[2:])
            mid, pt = a[8].shape[-1], 128 * t
            # the parent's C entry took Wproj as (mid, 3, mid), permuted by its wrapper
            pargs = cargs[:13] + (cargs[13].permute(0, 2, 1).contiguous().view(mid, mid, 3),) \
                + cargs[14:]

            def run(xs):
                keep = []
                out = _launch_forward_bf16(*xs, heads, 4, 1e-5, keep=keep)
                return out, keep[0][:pt * 6 * mid].reshape(pt, 6, mid).clone()

            with bound_to(args.parent):
                po, pcat = run(pargs)
            no, ncat = run(cargs)
            print(f"diff {label}: main conv and MHCAs (slices 0-4) "
                  f"{diff_text(ncat[:, :5], pcat[:, :5])}; gated slice 5 "
                  f"{diff_text(ncat[:, 5], pcat[:, 5])}; output {diff_text(no, po)}", flush=True)
            ab(label, lambda: fused_csp(*cargs, attn_heads=heads),
               lambda: fused_csp(*pargs, attn_heads=heads))

        blk, a = smoke.tblock_case(model, "backbone.self_att_V.0", 64, 224, gen, dev)
        heads = blk.attn.n_head
        p, n = both(lambda: fused_tblock(*a, heads=heads, cdtype=bf))
        print(f"same tblock_bf16@64x224x512: {torch.equal(p, n)} ({diff_text(n, p)})",
              flush=True)
        ab("tblock_bf16@64x224x512", lambda: fused_tblock(*a, heads=heads, cdtype=bf))

        m, seq = 128 * 224, 224
        x = torch.randn(m, 1536, generator=gen).to(dev, bf)
        h = torch.randn(m, 256, generator=gen).to(dev, bf)
        w = (torch.randn(512, 1536, generator=gen) / math.sqrt(1536)).to(dev, bf)
        wq = (torch.randn(3, 256, 256, generator=gen) / 16).to(dev, bf)
        wp = (torch.randn(256, 768, generator=gen) / math.sqrt(768)).to(dev, bf)
        bias = (0.1 * torch.randn(512, generator=gen)).to(dev, bf)
        rowmask = torch.rand(m, generator=gen).to(dev) > 0.2
        seqmul = (1 + 0.3 * torch.randn(m // seq, 512, generator=gen)).to(dev)
        resid = torch.randn(m, 512, generator=gen).to(dev)
        cases = {
            "final": [dict(x=x, w=w, bias=bias, rowmask=rowmask)],
            "qkv3": [dict(x=h, w=wq[i], bias=bias[:256], rowmask=rowmask if i == 2 else None,
                          scale=0.125 if i == 0 else 1.0) for i in range(3)],
            "proj_conv": [dict(x=h, w=wp, taps=3, seq=seq, bias=bias[:256], rowmask=rowmask)],
            "gelu_scale": [dict(x=x, w=w, bias=bias, act="gelu", scale=0.3)],
            "tail": [dict(x=x, w=w, bias=bias, rowmask=rowmask, seq=seq, seqmul=seqmul,
                          out=torch.empty_like(resid))],
            "raw": [dict(x=x, w=w, raw=True)],
            "t7_final": [dict(x=x[:128 * 7], w=w, bias=bias, rowmask=rowmask[:128 * 7])],
        }
        for name, calls in cases.items():
            def run():
                for cl in calls:
                    if "out" in cl:
                        cl["out"].copy_(resid)
                return [o.clone() for o in bf16_products(calls)]

            p, n = both(run)
            same = all(torch.equal(u, v) for u, v in zip(p, n))
            print(f"same product_bf16@{name}: {same} "
                  f"({'; '.join(diff_text(v, u) for u, v in zip(p, n))})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
