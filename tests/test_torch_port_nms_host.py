"""ops/nms_host.py, the port of the JAX package's host Soft-NMS: the same C
scan (native/nms1d.c) built under build/host/, bit-identical to the JAX
module's binding, and agreeing with the port's plain Soft-NMS as the JAX
package's host scan agrees with its device NMS (tests/test_nms_host.py)."""

import os

import numpy as np
import pytest
import torch

from unav_yolyolva_tpu.ops import nms_host as jax_host
from unav_yolyolva_tpu_torch.ops import nms_host
from unav_yolyolva_tpu_torch.ops.nms import hard_nms_fixed, soft_nms_fixed
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)

NATIVE = nms_host.ROOT / "native"


def _soft_case(seed, n=60):
    rng = np.random.default_rng(seed)
    starts = rng.uniform(0, 100, n)
    segs = np.stack([starts, starts + rng.uniform(1, 25, n)], 1).astype(np.float32)
    return segs, rng.uniform(0.001, 1.0, n).astype(np.float32)


def _hard_case(seed=2, n=40):
    rng = np.random.default_rng(seed)
    starts = rng.uniform(0, 50, n)
    segs = np.stack([starts, starts + rng.uniform(1, 15, n)], 1).astype(np.float32)
    return segs, rng.uniform(0.1, 1.0, n).astype(np.float32)


def _rows(segs, scores):
    return torch.from_numpy(segs)[None], torch.from_numpy(scores)[None]


@pytest.mark.parametrize("seed", [0, 5])
def test_host_matches_plain_soft(seed):
    segs, scores = _soft_case(seed)
    idx_h, sc_h = nms_host.soft_nms_host(segs, scores, 0.7, 0.4, 0.001, method=2)
    s, sc = _rows(segs, scores)
    idx_d, sc_d, ok_d = soft_nms_fixed(s, sc, torch.ones_like(sc, dtype=torch.bool),
                                       len(scores), 0.7, 0.4, 0.001)
    k = int(ok_d.sum())
    assert k == len(idx_h)
    np.testing.assert_array_equal(idx_d[0, :k].numpy(), idx_h)
    np.testing.assert_allclose(sc_d[0, :k].numpy(), sc_h, rtol=1e-4)


def test_host_matches_plain_hard():
    segs, scores = _hard_case()
    idx_h, sc_h = nms_host.hard_nms_host(segs, scores, 0.5)
    s, sc = _rows(segs, scores)
    idx_d, sc_d, ok_d = hard_nms_fixed(s, sc, torch.ones_like(sc, dtype=torch.bool),
                                       len(scores), iou_threshold=0.5, min_score=0.0)
    k = int(ok_d.sum())
    assert k == len(idx_h)
    np.testing.assert_array_equal(idx_d[0, :k].numpy(), idx_h)
    np.testing.assert_array_equal(sc_d[0, :k].numpy(), sc_h)


CASES = [("soft", seed, method, cap) for seed in (0, 5) for method in (0, 1, 2)
         for cap in (None, 7)] + [("hard", 2, None, cap) for cap in (None, 7)]


@pytest.mark.parametrize("kind,seed,method,cap", CASES)
def test_bit_identical_to_the_jax_binding(kind, seed, method, cap):
    if kind == "soft":
        segs, scores = _soft_case(seed)
        args = (segs, scores, 0.7, 0.4, 0.001)
        got = nms_host.soft_nms_host(*args, method=method, max_out=cap)
        ref = jax_host.soft_nms_host(*args, method=method, max_out=cap)
    else:
        segs, scores = _hard_case(seed)
        got = nms_host.hard_nms_host(segs, scores, 0.5, max_out=cap)
        ref = jax_host.hard_nms_host(segs, scores, 0.5, max_out=cap)
    assert len(got[0]) == len(ref[0]) and (cap is None or len(got[0]) <= cap)
    assert got[0].dtype == np.int64 and got[1].dtype == np.float32
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1].tobytes() == ref[1].tobytes()


def test_no_candidates_give_empty_arrays():
    empty = np.zeros((0, 2), np.float32), np.zeros(0, np.float32)
    for idx, sc in (nms_host.soft_nms_host(*empty, 0.7, 0.4, 0.001),
                    nms_host.hard_nms_host(*empty, 0.5)):
        assert idx.shape == (0,) and sc.shape == (0,)
        assert idx.dtype == np.int64 and sc.dtype == np.float32


def _native_state():
    return {f: (os.stat(NATIVE / f).st_mtime_ns, (NATIVE / f).read_bytes())
            for f in sorted(os.listdir(NATIVE))}


def test_builds_under_build_and_leaves_native_alone(tmp_path, monkeypatch):
    jax_host._lib()                      # whatever the JAX binding writes, before the snapshot
    before = _native_state()
    nms_host.soft_nms_host(*_soft_case(0), 0.7, 0.4, 0.001)
    built = nms_host.library_path()
    assert built.exists() and built.parent == nms_host.ROOT / "build" / "host"
    monkeypatch.setattr(nms_host, "BUILD_DIR", tmp_path / "host")
    fresh = nms_host.build()
    assert fresh.parent == tmp_path / "host" and fresh.name == built.name
    assert sorted(p.name for p in fresh.parent.iterdir()) == [built.name]
    assert _native_state() == before


def test_no_compiler_raises_native_unavailable(tmp_path, monkeypatch):
    monkeypatch.setattr(nms_host, "BUILD_DIR", tmp_path / "host")
    monkeypatch.setattr(nms_host, "CC", "no-such-compiler-unav")
    monkeypatch.setattr(nms_host, "_LIB", None)
    with pytest.raises(nms_host.NativeUnavailable, match="no-such-compiler-unav"):
        nms_host.soft_nms_host(*_soft_case(0), 0.7, 0.4, 0.001)
    with pytest.raises(nms_host.NativeUnavailable):
        nms_host.hard_nms_host(*_hard_case(), 0.5)
    assert not (tmp_path / "host").exists() or not any((tmp_path / "host").iterdir())
