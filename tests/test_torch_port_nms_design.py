"""The Soft-NMS kernels' algorithms (csrc/nms.cu), emulated in numpy on the
CPU, against the Pallas kernels in interpret mode and the port's plain
versions.

- The merged scan as the kernel runs it: the live lanes bucketed by
  cls mod NB in an order unrelated to their index (here: reversed), a head
  per bucket kept by the key (order-preserving score bits, inverted index),
  the argmax over the heads, and only the winner's bucket decayed (its other
  classes compared when the bucket holds several) before its head is
  recomputed.
- The single-class scan: the live lanes compacted in order, thread t of
  TPR holding compacted lanes t + TPR j, one pass a step that decays and
  keeps each thread's first best, the threads' bests reduced by key, the
  compacted position mapped back to the original index.

Tolerance: `_check_emissions` of tests/test_torch_port_nms.py (scores
within rtol 1e-5, indices equal where neighbouring scores differ by more
than 1e-6, valid slots equal). Where no segments overlap, no score moves,
so the order is decided by the ties alone and indices must be equal
everywhere."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from unav_yolyolva_tpu.ops.pallas_nms import multiclass_soft_nms_pallas, soft_nms_pallas
from unav_yolyolva_tpu_torch.ops.fused_nms import (multiclass_soft_nms_reference,
                                                   soft_nms_reference)
from tests._torch_port_common import t
from tests.test_torch_port_nms import _check_emissions
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)

F32 = np.float32
EPS = F32(1e-6)


def _key(s):
    """The kernel's order-preserving bits of a live score (0: dead)."""
    if s == -np.inf:
        return 0
    u = int(np.array(F32(0.0) if s == 0 else s, F32).view(np.uint32))
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)


def _decayed(s, x1, x2, sx1, sx2, method, thr, sigma, min_score):
    """The kernel's float32 arithmetic for one lane."""
    area_i = F32(sx2 - sx1) + EPS
    inter = max(F32(0.0), F32(min(sx2, x2) - max(sx1, x1)))
    iou = F32(inter / F32(F32(area_i + F32(F32(x2 - x1) + EPS)) - inter))
    if method == 0:
        w = F32(1.0) if iou < thr else F32(0.0)
    elif method == 1:
        w = F32(1.0) - iou if iou >= thr else F32(1.0)
    else:
        w = F32(np.exp(F32(-(iou * iou)) / F32(sigma)))
    sn = F32(s * w)
    return -np.inf if sn < min_score else sn


def merged_emulation(segs, scores, cls, *, max_out, sigma, min_score, nb=128):
    """The head-per-bucket scan, row by row."""
    g, n = scores.shape
    out_i = np.full((g, max_out), -1, np.int32)
    out_s = np.zeros((g, max_out), F32)
    for r in range(g):
        live = [i for i in range(n) if scores[r, i] > -np.inf][::-1]   # any order
        buckets = {}
        for i in live:
            buckets.setdefault(int(cls[r, i]) & (nb - 1), []).append(i)
        s = {i: F32(scores[r, i]) for i in live}
        mixed = {b: len({int(cls[r, i]) for i in lanes}) > 1 for b, lanes in buckets.items()}

        def head(b):
            keys = [(_key(s[i]), ~i & 0xFFFFFFFF, i) for i in buckets[b] if s[i] != -np.inf]
            return max(keys) if keys else (0, 0, -1)

        heads = {b: head(b) for b in buckets}
        for k in range(max_out):
            hi, _, wi = max(heads.values(), default=(0, 0, -1))
            if hi == 0:
                break
            out_i[r, k], out_s[r, k] = wi, s[wi]
            wb, wcls = int(cls[r, wi]) & (nb - 1), int(cls[r, wi])
            sx1, sx2 = segs[r, wi]
            for i in buckets[wb]:
                if s[i] == -np.inf:
                    continue
                if i == wi:
                    s[i] = -np.inf
                elif not mixed[wb] or int(cls[r, i]) == wcls:
                    s[i] = _decayed(s[i], segs[r, i, 0], segs[r, i, 1], sx1, sx2, 2, 0.0,
                                    sigma, min_score)
            heads[wb] = head(wb)
    return out_i, out_s, out_i >= 0


def soft_emulation(segs, scores, *, max_out, iou_threshold, sigma, min_score, method, tpr):
    """The live-compacted single-class scan with tpr threads a row."""
    g, n = scores.shape
    out_i = np.full((g, max_out), -1, np.int32)
    out_s = np.zeros((g, max_out), F32)
    for r in range(g):
        orig = np.nonzero(scores[r] > -np.inf)[0]                 # compaction, in order
        s = scores[r, orig].astype(F32)
        x = segs[r, orig]
        slots = -(-len(orig) // tpr)

        def thread_bests():
            best = []
            for tid in range(tpr):
                bk, bq = 0, -1
                for j in range(slots):
                    q = tid + tpr * j
                    if q < len(orig) and _key(s[q]) > bk:       # first max of the thread
                        bk, bq = _key(s[q]), q
                best.append((bk, ~bq & 0xFFFFFFFF if bq >= 0 else 0, bq))
            return best

        best = thread_bests()
        for k in range(max_out):
            hi, _, wq = max(best)
            if hi == 0:
                break
            out_i[r, k], out_s[r, k] = orig[wq], s[wq]
            sx1, sx2 = x[wq]
            for q in range(len(orig)):                            # the decay pass
                if s[q] == -np.inf:
                    continue
                s[q] = -np.inf if q == wq else _decayed(s[q], x[q, 0], x[q, 1], sx1, sx2,
                                                        method, iou_threshold, sigma,
                                                        min_score)
            best = thread_bests()
    return out_i, out_s, out_i >= 0


def _rows(seed, g, n, ncls, *, dead=0.3, ties=False, prefix=False, apart=False):
    """Segments (overlapping, or `apart`: disjoint), scores (distinct, or
    `ties`: eight levels, equal across and within classes), classes, some
    dead lanes (or, `prefix`, the live lanes first and score-descending, as
    group_by_class gives) and an all-dead last row."""
    rng = np.random.default_rng(seed)
    if apart:
        start = np.broadcast_to(np.arange(n, dtype=np.float64) * 10, (g, n))
        width = np.full((g, n), 5.0)
    else:
        start = rng.uniform(0, 40, size=(g, n))
        width = rng.uniform(0.5, 10, size=(g, n))
    segs = np.stack([start, start + width], -1).astype(F32)
    if ties:
        scores = (rng.integers(1, 9, size=(g, n)) / 8).astype(F32)
    else:
        scores = ((rng.permutation(g * n) + 1) / (g * n + 1)).reshape(g, n).astype(F32)
    scores[rng.uniform(size=(g, n)) < dead] = -np.inf
    if prefix:
        scores = -np.sort(-scores, axis=1)
    scores[-1] = -np.inf
    cls = rng.integers(0, ncls, size=(g, n)).astype(np.int32)
    return segs, scores, cls


MERGED_CASES = {
    "c_below_nb": dict(g=4, n=90, ncls=5),
    "c_above_nb": dict(g=3, n=300, ncls=300),
    "c_above_small_nb": dict(g=3, n=77, ncls=20, nb=8),
    "one_class": dict(g=3, n=70, ncls=1),
    "ties": dict(g=3, n=64, ncls=4, ties=True),
    "ties_apart": dict(g=3, n=45, ncls=3, ties=True, apart=True),
    "max_out_above_live": dict(g=3, n=33, ncls=3, max_out=40, dead=0.5),
    "prefix": dict(g=3, n=96, ncls=6, prefix=True),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(MERGED_CASES))
def test_merged_head_per_bucket(name, seed):
    kw = dict(MERGED_CASES[name])
    max_out, nb = kw.pop("max_out", 30), kw.pop("nb", 128)
    segs, scores, cls = _rows(seed, **kw)
    nms = dict(max_out=max_out, sigma=0.5, min_score=0.05)
    emu = merged_emulation(segs, scores, cls, nb=nb, **nms)
    pal = multiclass_soft_nms_pallas(jnp.asarray(segs), jnp.asarray(scores), jnp.asarray(cls),
                                     iou_threshold=0.0, interpret=True, **nms)
    plain = multiclass_soft_nms_reference(t(segs), t(scores), t(cls), **nms)
    _check_emissions(*emu, *pal)
    _check_emissions(*emu, *plain)
    assert (emu[0][-1] == -1).all() and (emu[1][-1] == 0).all()       # the all-dead row
    if kw.get("apart"):   # no overlaps: ties alone order the emissions, lowest index first
        np.testing.assert_array_equal(emu[0], np.asarray(pal[0]))
        np.testing.assert_array_equal(emu[0], plain[0].numpy())
        for r in range(kw["g"] - 1):
            want = sorted(np.nonzero(scores[r] > -np.inf)[0], key=lambda i: (-scores[r, i], i))
            np.testing.assert_array_equal(emu[0][r, :len(want[:max_out])], want[:max_out])


SOFT_CASES = {
    "scattered": dict(g=5, n=96),
    "prefix": dict(g=5, n=100, prefix=True),
    "n_not_multiple_of_32": dict(g=4, n=45),
    "full": dict(g=3, n=64, dead=0.0),
    "ties": dict(g=3, n=70, ties=True),
    "ties_apart": dict(g=3, n=120, ties=True, apart=True),
    "max_out_above_live": dict(g=3, n=20, max_out=30, dead=0.4),
}


@pytest.mark.parametrize("method", [0, 1, 2])
@pytest.mark.parametrize("name", list(SOFT_CASES))
def test_single_class_live_compacted(name, method):
    kw = dict(SOFT_CASES[name])
    max_out = kw.pop("max_out", 25)
    segs, scores, _ = _rows(method + 3, ncls=1, **kw)
    nms = dict(max_out=max_out, iou_threshold=0.4, sigma=0.5, min_score=0.05, method=method)
    pal = soft_nms_pallas(jnp.asarray(segs), jnp.asarray(scores), interpret=True, row_block=8,
                          **nms)
    plain = soft_nms_reference(t(segs), t(scores), **nms)
    for tpr in (32, 1024) if name == "scattered" else (32,):   # a warp row, a block row
        emu = soft_emulation(segs, scores, tpr=tpr, **nms)
        _check_emissions(*emu, *pal)
        _check_emissions(*emu, *plain)
        assert (emu[0][-1] == -1).all() and (emu[1][-1] == 0).all()
        if kw.get("apart"):
            np.testing.assert_array_equal(emu[0], np.asarray(pal[0]))
            np.testing.assert_array_equal(emu[0], plain[0].numpy())


def test_key_orders_like_floats():
    """The packed key orders scores as floats do, with either zero equal
    and -inf dead."""
    vals = np.array([-3e38, -2.5, -1e-30, -0.0, 0.0, 1e-30, 0.001, 0.5, 1.0, 3e38], F32)
    keys = [_key(v) for v in vals]
    assert all(a < b for a, b in zip(keys[:3], keys[1:4]))
    assert keys[3] == keys[4] and all(a < b for a, b in zip(keys[4:], keys[5:]))
    assert _key(F32(-np.inf)) == 0 < keys[0]


def test_bench_cases_cover_the_protocol():
    """The chip script's NMS cases, at a small batch on the CPU: the capped
    rows are each video's top 2000, the skewed classes hold about half and
    a quarter of the lanes in classes 0 and 1, the per-class buffers are
    the group_by_class rows."""
    from unav_yolyolva_tpu_torch.tools import nms_bench

    base = nms_bench.protocol_candidates(torch.Generator().manual_seed(0), "cpu", g=2, n=3000)
    cases = {label: (merged, args) for label, merged, args, _ in
             nms_bench.cases(base, torch.Generator().manual_seed(1))}
    assert list(cases) == ["nms@2x3000", "nms@2x2000", "nms@2x3000/skewed",
                           "soft_nms@200x1024/m0", "soft_nms@200x1024/m1",
                           "soft_nms@200x1024/m2", "soft_nms@2x3000/m2"]
    capped = cases["nms@2x2000"][1][1]
    top = torch.where(torch.isfinite(base[1]), base[1], -1.0).topk(2000, dim=1).values
    np.testing.assert_array_equal(torch.where(torch.isfinite(capped), capped, -1.0), top)
    share = torch.bincount(cases["nms@2x3000/skewed"][1][2][0].long(), minlength=100) / 3000
    assert abs(share[0] - 0.5) < 0.05 and abs(share[1] - 0.25) < 0.05 and share.max() == share[0]
    assert cases["soft_nms@200x1024/m0"][1][1].shape == (200, 1024)
    steps = nms_bench.row_steps(torch.tensor([[3, 1, -1, -1], [0, 2, 1, 3]]), 4)
    assert steps.tolist() == [3, 4]


def test_check_nms_accepts_only_min_score_near_ties():
    """A slot one side leaves empty while the other emits a score in
    [float32(min_score), two ulps above] passes only when min_score is
    given; any other score there (above the band, under float32(min_score),
    0), on either side, and any other difference fails."""
    from unav_yolyolva_tpu_torch.tools.nms_bench import check_nms

    lo = np.float32(0.001)
    up = lambda x, k: x if k == 0 else up(np.nextafter(x, np.float32(1)), k - 1)  # noqa: E731
    ri = torch.tensor([[4, 2, -1, -1]], dtype=torch.int32)
    rs = torch.tensor([[0.9, 0.5, 0.0, 0.0]])
    log = lambda *a: None  # noqa: E731
    for k in (0, 1, 2):
        ki, ks = ri.clone(), rs.clone()
        ki[0, 2], ks[0, 2] = 7, float(up(lo, k))
        assert check_nms(ki, ks, ri, rs, log=log, min_score=0.001) < 1e-7
        assert check_nms(ri, rs, ki, ks, log=log, min_score=0.001) < 1e-7   # plain side emits
    with pytest.raises(AssertionError):
        check_nms(ki, ks, ri, rs, log=log)
    for bad in (float(up(lo, 3)), 0.002, float(np.nextafter(lo, np.float32(0))), 0.0009, 0.0):
        ki, ks = ri.clone(), rs.clone()
        ki[0, 2], ks[0, 2] = 7, bad
        with pytest.raises(AssertionError):
            check_nms(ki, ks, ri, rs, log=log, min_score=0.001)
        with pytest.raises(AssertionError):
            check_nms(ri, rs, ki, ks, log=log, min_score=0.001)
    with pytest.raises(AssertionError):
        check_nms(torch.tensor([[2, 4, -1, -1]], dtype=torch.int32), rs, ri, rs, log=log,
                  min_score=0.001)


@pytest.mark.parametrize("merged", [False, True])
def test_edge_reading_replays_the_plain_kill(merged):
    """The replay of a lane's decays reproduces the plain scan's float32
    products: the lane that the plain scan kills under min_score dies at
    the step that killed it, and its fp64 product lies within float32
    rounding of the float32 one. A lane never decayed reads None.
    `check_edges` accepts a slot filled on one side only where that fp64
    product lies within 2 ulp of float32(min_score)."""
    from unav_yolyolva_tpu_torch.tools import nms_bench

    # lane 1 overlaps winner 0 (IoU 0.8) and dies at 0.004 * exp(-0.64 / 0.4);
    # lane 2 lies apart; lane 3 (another class when merged) overlaps lane 1
    segs = torch.tensor([[[0.0, 10.0], [0.0, 8.0], [50.0, 60.0], [1.0, 9.0]]])
    kw = dict(max_out=4, sigma=0.4, min_score=0.001)
    if not merged:
        kw.update(iou_threshold=0.7, method=2)
    cls = torch.tensor([[3, 3, 3, 5]], dtype=torch.int32)

    def scan(s1):
        args = (segs, torch.tensor([[0.9, s1, 0.5, 0.3]]), cls)[:3 if merged else 2]
        ri, rs, _ = nms_bench.reference(merged, args, kw)
        return args, ri, rs, nms_bench.edge_reading(merged, args, kw, ri[0].tolist(), 0, 1)

    args, ri, rs, r = scan(0.004)
    assert 1 not in ri[0].tolist()
    assert r["step"] == 0 and r["winner"] == 0 and r["died"]
    w = np.exp(-(0.8 ** 2) / 0.4)
    np.testing.assert_allclose(r["prod64"], np.float64(np.float32(0.004)) * w, rtol=1e-6)
    np.testing.assert_allclose(r["prod"], r["prod64"], rtol=1e-6)
    assert r["ulps"] < -2
    assert nms_bench.edge_reading(merged, args, kw, ri[0].tolist(), 0, 2) is None

    ki, ks = ri.clone(), rs.clone()
    ki[0, 3], ks[0, 3] = 1, 0.001                     # the kernel keeps lane 1
    lines = []
    with pytest.raises(AssertionError, match="not a near-tie"):
        nms_bench.check_edges("case", merged, args, kw, ki, ks, ri, rs, log=lines.append)
    assert "lane 1, kernel emits" in lines[0] and "(killed)" in lines[0]

    # lane 1 at a score whose product the plain scan rounds just under min_score
    s0, found = np.float32(0.001 / w), None
    for k in range(16):                               # s0 and the 15 floats under it
        s1 = s0
        for _ in range(k):
            s1 = np.nextafter(s1, np.float32(0))
        args, ri, rs, r = scan(float(s1))
        if r["step"] == 0 and r["died"] and abs(r["ulps"]) <= 2:
            found = (args, ri, rs)
            break
    assert found is not None
    args, ri, rs = found
    ki, ks = ri.clone(), rs.clone()
    ki[0, 3], ks[0, 3] = 1, float(np.float32(0.001))
    lines = []
    nms_bench.check_edges("case", merged, args, kw, ki, ks, ri, rs, log=lines.append)
    assert len(lines) == 1 and "(killed)" in lines[0]
    assert nms_bench.check_nms(ki, ks, ri, rs, log=lines.append, min_score=0.001) == 0.0
    with pytest.raises(AssertionError, match="never decays"):
        nms_bench.check_edges("case", merged, args, kw, ri, rs, ki.where(ki != 1, 2), ks,
                              log=lines.append)


def test_library_path_names_each_source(tmp_path):
    """A library built from another file (another checkout's nms.cu) gets a
    path of its own; the default is this checkout's `csrc/<name>.cu`."""
    from unav_yolyolva_tpu_torch.ops import cuda_build

    own = cuda_build.CSRC / "nms.cu"
    assert cuda_build.library_path("nms") == cuda_build.library_path("nms", own)
    other = tmp_path / "nms.cu"
    other.write_text(own.read_text() + "\n// another version\n")
    (tmp_path / "common.cuh").write_text((cuda_build.CSRC / "common.cuh").read_text())
    path = cuda_build.library_path("nms", other)
    assert path != cuda_build.library_path("nms") and path.parent == cuda_build.BUILD_DIR
    assert path.name.startswith("libunav_nms-")


def test_ptxas_table_reads_each_instantiation():
    from unav_yolyolva_tpu_torch.tools.nms_bench import ptxas_table

    name = "_ZN38_GLOBAL__N__5e320b8e_6_nms_cu_f4e9db9115soft_nms_kernelILi32ELi4EEEvPKfS2_iiiifffPiPf"
    merged = "_ZN38_GLOBAL__N__5e320b8e_6_nms_cu_f4e9db9117merged_nms_kernelEPKfS1_PKiiiffPiPf"
    report = f"""ptxas info    : Compiling entry function '{name}' for 'sm_90a'
ptxas info    : Function properties for {name}
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers
ptxas info    : Compiling entry function '{merged}' for 'sm_90a'
ptxas info    : Function properties for {merged}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 2 barriers, 2720 bytes smem
"""
    assert ptxas_table(report) == {"soft_nms_kernel<32,4>": (40, 8, 4),
                                   "merged_nms_kernel": (64, 0, 0)}
