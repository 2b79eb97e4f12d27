"""The Soft-NMS kernels at the eval protocol's shapes: the cases, the
per-case `stages nms@...` line, and an A/B timing against another
checkout's kernels on the same card.

    python -m unav_yolyolva_tpu_torch.tools.nms_bench [--parent DIR] [--seed N]

Cases (configs/avel_unav100_eval.yaml: 100 classes, pre_nms_thresh 0.001,
max_seg_num 100, sigma 0.4, iou 0.7, min_score 0.001), each held against
the plain version (scores rtol 1e-5, indices on unambiguous slots):
- merged (64, 10100): one batch's decoded candidates, uniform classes;
- merged (64, 2000): the top 2000 of each video (`tpu.nms_max_candidates`);
- merged (64, 10100) skewed: half the candidates in class 0, a quarter in
  class 1, the rest uniform over the other 98;
- single-class (6400, 1024): the per-class buffers of `group_by_class`
  (hard NMS), with the hard, linear and Gaussian weights;
- single-class (64, 10100): one row per video (`multiclass_nms: False`).

With --parent DIR (a checkout, e.g. unpacked by `git archive`), builds that
checkout's `csrc/nms.cu` too and times both libraries' scans through the
same raw call in turns (parent, change, change, parent), one `ab ...` line a
case. A slot that one side leaves empty while the other emits a score at
min_score gets a `min_score edge ...` line: the plain scan's decays of that
lane replayed, with the deciding product in fp64, which must lie within
EDGE_ULPS (2) ulp of float32(min_score). Needs a CUDA device;
exits non-zero without one.
"""

from __future__ import annotations

import argparse
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import cuda_build
from ..ops import fused_nms
from ..ops.fused_nms import (launch_info, multiclass_soft_nms, multiclass_soft_nms_reference,
                             soft_nms, soft_nms_reference)
from ..ops.nms import group_by_class

NUM_CLASSES, MAX_OUT = 100, 100
EDGE_ULPS = 2         # float32 ulps at min_score: the card's `expf` is within 2 ulp


def protocol_candidates(gen, dev, g=64, n=10100, ncls=NUM_CLASSES):
    """Candidates shaped like the decode output at the eval protocol: scores
    sigmoid(N(0,1) - 4) with those <= 0.001 dead, a zero-padded last video."""
    centre = torch.rand(g, n, generator=gen) * 224
    width = torch.rand(g, n, generator=gen) ** 2 * 120 + 0.1
    segs = torch.stack([centre - width / 2, centre + width / 2], -1)
    scores = torch.sigmoid(torch.randn(g, n, generator=gen) - 4.0)
    scores[scores <= 0.001] = float("-inf")                    # below pre_nms_thresh
    scores[-1] = float("-inf")                                 # a zero-padded video
    cls = torch.randint(0, ncls, (g, n), generator=gen, dtype=torch.int32)
    return segs.to(dev), scores.to(dev), cls.to(dev)


def cases(base, gen):
    """[(label, merged, args, kwargs)] from the protocol candidates `base`;
    `gen` draws the skewed classes."""
    segs, scores, cls = base
    g, n = scores.shape
    mkw = dict(max_out=MAX_OUT, sigma=0.4, min_score=0.001)
    # the decode's cap: the top 2000 of where(valid, score, -1), ties to the lower index
    top = torch.where(torch.isfinite(scores), scores, -1.0).sort(
        dim=1, descending=True, stable=True).indices[:, :2000]
    capped = (segs.gather(1, top[..., None].expand(-1, -1, 2)).contiguous(),
              scores.gather(1, top).contiguous(), cls.gather(1, top).contiguous())
    u = torch.rand(g, n, generator=gen)
    skew = torch.where(u < 0.5, 0, torch.where(u < 0.75, 1, 2 + (torch.rand(
        g, n, generator=gen) * (NUM_CLASSES - 2)).long().clamp(max=NUM_CLASSES - 3)))
    out = [(f"nms@{g}x{n}", True, (segs, scores, cls), mkw),
           (f"nms@{g}x2000", True, capped, mkw),
           (f"nms@{g}x{n}/skewed", True, (segs, scores, skew.int().to(cls.device)), mkw)]
    valid = torch.isfinite(scores)
    bsegs, bscores, _ = group_by_class(segs, torch.where(valid, scores, 0.0), cls, valid,
                                       NUM_CLASSES, 1024)
    rows = (bsegs.reshape(-1, 1024, 2).contiguous(), bscores.reshape(-1, 1024).contiguous())
    for m in (0, 1, 2):
        out.append((f"soft_nms@{g * NUM_CLASSES}x1024/m{m}", False, rows,
                    dict(max_out=MAX_OUT, iou_threshold=0.7, sigma=0.4, min_score=0.001,
                         method=m)))
    out.append((f"soft_nms@{g}x{n}/m2", False, (segs, scores),
                dict(max_out=MAX_OUT, iou_threshold=0.7, sigma=0.4, min_score=0.001,
                     method=2)))
    return out


def run(merged, args, kw):
    return (multiclass_soft_nms if merged else soft_nms)(*args, **kw)


def reference(merged, args, kw):
    return (multiclass_soft_nms_reference if merged else soft_nms_reference)(*args, **kw)


def row_steps(ref_idx, max_out):
    """Dependent steps each row runs: its emissions, plus the step that finds
    nothing alive when it stops early."""
    return (ref_idx >= 0).sum(1).clamp(max=max_out - 1) + 1


def kill_edge(min_score: float, device=None):
    """The scores a lane may carry at min_score's edge: [float32(min_score),
    EDGE_ULPS float32 ulps above]. The kill test is s * w < min_score in
    float32, so a lane that survives it sits at or above float32(min_score);
    a product that close to it is a near-tie that the kernel's arithmetic
    (its `expf` is within 2 ulp) and torch's may decide either way."""
    lo = torch.tensor(min_score, dtype=torch.float32, device=device)
    hi, inf = lo, torch.tensor(float("inf"), device=device)
    for _ in range(EDGE_ULPS):
        hi = torch.nextafter(hi, inf)
    return lo, hi


def one_sided(ki, ri):
    """[(row, slot)] of the slots that one side fills and the other leaves empty."""
    return [tuple(rc) for rc in ((ki < 0) != (ri < 0)).nonzero().tolist()]


def check_nms(ki, ks, ri, rs, what="nms", log=print, min_score=None):
    """Scores within rtol 1e-5; indices equal wherever neighbouring emitted
    scores differ by more than 1e-6. With `min_score`, a slot that one side
    leaves empty while the other emits a score in `kill_edge(min_score)` is
    a near-tie of the kill test: such slots are counted and logged, not
    compared; any other slot that one side alone fills fails. Returns the
    largest score error over the compared slots."""
    edge = (ki < 0) != (ri < 0)
    cmp = torch.ones_like(ks, dtype=torch.bool)
    if min_score is not None:
        lo, hi = kill_edge(min_score, ks.device)
        emitted = torch.where(ki >= 0, ks, rs)
        cmp = ~(edge & (emitted >= lo) & (emitted <= hi))
    err = float((ks - rs).abs()[cmp].max()) if cmp.any() else 0.0
    if not torch.allclose(ks[cmp], rs[cmp], rtol=1e-5, atol=1e-7):
        raise AssertionError(f"{what}: scores differ (max abs {err})")
    if bool((edge & cmp).any()):
        raise AssertionError(f"{what}: {int((edge & cmp).sum())} slot(s) filled on one side "
                             "only, outside min_score's edge")
    d = (rs[:, 1:] - rs[:, :-1]).abs()
    inf = torch.full_like(rs[:, :1], float("inf"))
    gap = torch.minimum(torch.cat([inf, d], 1), torch.cat([d, inf], 1))
    sure = (gap > 1e-6) & cmp
    mism = int((ki[sure] != ri[sure]).sum())
    log(f"check {what}: max_abs_err={err:.3e} unambiguous_slots={int(sure.sum())} "
        f"index_mismatches={mism} emitted={int((ki >= 0).sum())} "
        f"min_score_near_ties={int((~cmp).sum())}")
    if mism:
        raise AssertionError(f"{what}: emitted indices differ from the plain version")
    return err


def _weight64(iou: float, kw) -> float:
    """The scan's weight in fp64: hard, linear or Gaussian (kw["method"],
    the merged scan's is Gaussian)."""
    method = kw.get("method", 2)
    if method == 0:
        return float(iou < kw["iou_threshold"])
    if method == 1:
        return 1.0 - iou if iou >= kw["iou_threshold"] else 1.0
    return math.exp(-(iou * iou) / kw["sigma"])


def edge_reading(merged, args, kw, winners, row: int, lane: int):
    """Replays the plain scan's decays of `lane` in row `row`. At each of the
    plain scan's `winners` (its emitted indices for that row) of the lane's
    class, the lane's score becomes the plain version's own float32 s * w
    (a two-lane row: the winner at 1.0, then the lane; min_score 0), until
    the lane is emitted or the product falls under float32(min_score).
    Returns the last decay (None if there was none): step, winner, s, the
    float32 product, the product with the weight in fp64 from the same
    float32 coordinates, its distance from float32(min_score) in float32
    ulps, and whether the lane died there."""
    lo, _ = kill_edge(kw["min_score"], args[1].device)
    ulp = float(torch.nextafter(lo, lo + 1) - lo)
    s, last = args[1][row, lane], None
    for step, j in enumerate(winners):
        if j < 0 or j == lane:
            break
        pair = [j, lane]
        if merged:
            if int(args[2][row, j]) != int(args[2][row, lane]):
                continue                                   # another class: weight 1
            out = multiclass_soft_nms_reference(
                args[0][row, pair][None], torch.stack([torch.ones_like(s), s])[None],
                args[2][row, pair][None], max_out=2, sigma=kw["sigma"], min_score=0.0)[1]
        else:
            out = soft_nms_reference(args[0][row, pair][None],
                                     torch.stack([torch.ones_like(s), s])[None],
                                     **dict(kw, max_out=2, min_score=0.0))[1]
        prod = out[0, 1]
        (sx1, sx2), (x1, x2) = args[0][row, j].tolist(), args[0][row, lane].tolist()
        inter = max(min(sx2, x2) - max(sx1, x1), 0.0)
        w64 = _weight64(inter / ((sx2 - sx1 + 1e-6) + (x2 - x1 + 1e-6) - inter), kw)
        if w64 < 1.0 or bool(prod < lo):
            p64 = float(s) * w64
            last = dict(step=step, winner=j, s=float(s), prod=float(prod), prod64=p64,
                        ulps=(p64 - float(lo)) / ulp, died=bool(prod < lo))
            if last["died"]:
                break
        s = prod
    return last


def check_edges(label, merged, args, kw, ki, ks, ri, rs, log=print):
    """One `min_score edge ...` line for each slot that one side leaves
    empty and the other fills: `edge_reading` of the emitted lane. Such a
    slot is a near-tie of the kill test only if the plain scan decayed
    that lane to within EDGE_ULPS float32 ulps of float32(min_score) in
    fp64; raises otherwise."""
    for row, slot in one_sided(ki, ri):
        side, idx, sc = ("kernel", ki, ks) if int(ki[row, slot]) >= 0 else ("plain", ri, rs)
        lane, score = int(idx[row, slot]), float(sc[row, slot])
        r = edge_reading(merged, args, kw, ri[row].tolist(), row, lane)
        head = f"min_score edge {label}: row {row} slot {slot} lane {lane}, {side} emits {score!r}"
        if r is None:
            raise AssertionError(f"{head}; the plain scan never decays it")
        log(f"{head}; plain scan step {r['step']} (winner {r['winner']}): s {r['s']!r}, "
            f"float32 s*w {r['prod']!r} ({'killed' if r['died'] else 'kept'}), fp64 s*w "
            f"{r['prod64']!r} = float32(min_score) {r['ulps']:+.3f} ulp")
        if abs(r["ulps"]) > EDGE_ULPS:
            raise AssertionError(f"{head}: the plain scan's product is {r['ulps']:+.3f} ulp "
                                 f"from min_score, not a near-tie")


def ptxas_table(report: str) -> dict:
    """{kernel instantiation: (registers, spill store bytes, spill load
    bytes)} from an `nvcc -Xptxas -v` report."""
    regs, spills, cur = {}, {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(_Z\w+)", line)
        if m:
            cur = demangle(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur:
            spills[cur] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            regs[cur] = int(m.group(1))
    return {k: (r, *spills.get(k, (0, 0))) for k, r in regs.items()}


def demangle(name: str) -> str:
    """`_ZN12_GLOBAL__N_115soft_nms_kernelILi32ELi4EEEvPKf...` ->
    `soft_nms_kernel<32,4>` (the two scans of csrc/nms.cu)."""
    m = re.search(r"\d+(merged_nms_kernel|soft_nms_kernel)((?:I(?:Li-?\d+E)+E)?)", name)
    if not m:
        return name
    targs = re.findall(r"Li(-?\d+)E", m.group(2))
    return m.group(1) + (f"<{','.join(targs)}>" if targs else "")


def instantiation(info: dict, merged: bool) -> str:
    if merged:
        return "merged_nms_kernel"
    return f"soft_nms_kernel<{32 if info['rows_per_block'] > 1 else 1024},{info['slots']}>"


def stage_text(label, ms, setup_ms, steps, info, merged, ptxas) -> str:
    """One `stages nms@...` line: time, the scan's time alone at max_out 1
    (setup and one step: `raw_ms`), the longest row's steps and ns a step beyond the first, the
    instantiation's registers and spills (ptxas, where this run compiled
    it; else the runtime's registers and local bytes) and its resident
    blocks per SM."""
    inst = instantiation(info, merged)
    longest = int(steps.max())
    if inst in ptxas:
        regs, st, ld = ptxas[inst]
        rtxt = f"{regs} registers, {st} B spill stores, {ld} B spill loads (ptxas)"
    else:
        rtxt = f"{info['registers']} registers, {info['local_bytes']} B local (runtime)"
    per_step = (ms - setup_ms) * 1e6 / max(longest - 1, 1)
    return (f"stages {label}: kernel {ms:.4f} ms, at max_out 1 {setup_ms:.4f} ms, longest "
            f"row {longest} steps ({per_step:.1f} ns a step beyond the first), "
            f"{int(steps.sum())} steps in all; {inst}: {rtxt}; {info['blocks_per_sm']} "
            f"resident block(s) of {info['threads']} threads an SM ({info['rows_per_block']} "
            f"row(s) a block, {info['smem_bytes']} B dynamic shared)")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device ms of `fn` over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def raw_scan(lib, merged, args, kw):
    """A call of `lib`'s scan on `args` without the wrapper's host work:
    returns (call, out_idx, out_score), the outputs made once and written
    by each call."""
    g, n = args[1].shape
    mo = kw["max_out"]
    oi = torch.empty((g, mo), dtype=torch.int32, device=args[1].device)
    os_ = torch.empty((g, mo), dtype=torch.float32, device=args[1].device)
    stream = torch.cuda.current_stream(args[1].device).cuda_stream
    ptrs = [a.data_ptr() for a in args]
    if merged:
        def call():
            cuda_build.check(lib, lib.unav_multiclass_soft_nms(
                *ptrs, g, n, mo, kw["sigma"], kw["min_score"], oi.data_ptr(), os_.data_ptr(),
                stream), "unav_multiclass_soft_nms")
    else:
        def call():
            cuda_build.check(lib, lib.unav_soft_nms(
                *ptrs, g, n, mo, kw["method"], kw["iou_threshold"], kw["sigma"],
                kw["min_score"], oi.data_ptr(), os_.data_ptr(), stream), "unav_soft_nms")
    return call, oi, os_


def raw_ms(merged, args, kw, iters: int = 20, lib=None) -> float:
    """Time of the scan alone (this checkout's, or `lib`'s), without the
    wrapper's host work: so that a short scan (max_out 1: the setup and one
    step) is timed on the device, not on the host."""
    lib = lib or cuda_build.library("nms", fused_nms._ARGTYPES)
    return cuda_ms(raw_scan(lib, merged, args, kw)[0], iters)


def smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="a checkout whose nms.cu is timed beside this one")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("nms_bench: no CUDA device", file=sys.stderr)
        return 2
    from ..core import resolve_device

    dev = resolve_device("cuda")
    card = smi()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}", flush=True)
    reports = cuda_build.build(["nms"])
    ptxas = ptxas_table(reports.get("nms", ""))
    libs = {"change": cuda_build.library("nms", fused_nms._ARGTYPES)}
    if args.parent:
        scans = ("unav_multiclass_soft_nms", "unav_soft_nms")     # what every version has
        libs["parent"] = cuda_build.library(
            "nms", {fn: fused_nms._ARGTYPES[fn] for fn in scans},
            source=args.parent.resolve() / "unav_yolyolva_tpu_torch" / "csrc" / "nms.cu")
    order = ["parent", "change", "change", "parent"] if args.parent else ["change"]
    gen = torch.Generator().manual_seed(args.seed + 1)
    base = protocol_candidates(gen, dev)
    for label, merged, cargs, kw in cases(base, torch.Generator().manual_seed(args.seed + 2)):
        ri, rs, _ = reference(merged, cargs, kw)
        ki, ks, _ = run(merged, cargs, kw)
        check_nms(ki, ks, ri, rs, f"{label} (wrapper)", min_score=kw["min_score"])
        check_edges(label, merged, cargs, kw, ki, ks, ri, rs)
        for name, lib in libs.items():
            call, oi, os_ = raw_scan(lib, merged, cargs, kw)
            call()
            check_nms(oi, os_, ri, rs, f"{label} ({name})", min_score=kw["min_score"])
        kw1 = dict(kw, max_out=1)
        times = {name: [] for name in libs}
        setup = {name: [] for name in libs}
        for name in order:
            times[name].append(raw_ms(merged, cargs, kw, args.iters, libs[name]))
            setup[name].append(raw_ms(merged, cargs, kw1, args.iters, libs[name]))
        steps = row_steps(ri, kw["max_out"])
        info = launch_info(cargs[1].shape[1], merged=merged)
        print(f"ab {label}: " + ", ".join(
            f"{name} " + " / ".join(f"{t:.4f}" for t in ts) + " ms (max_out 1: "
            + " / ".join(f"{t:.4f}" for t in setup[name]) + ")" for name, ts in times.items())
            + f"; longest row {int(steps.max())} steps [{card}]", flush=True)
        print(stage_text(label, min(times["change"]), min(setup["change"]), steps, info, merged,
                         ptxas) + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
