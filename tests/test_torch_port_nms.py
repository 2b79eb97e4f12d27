"""PyTorch port vs the JAX package: the single-class Soft-NMS scan and the
non-merged NMS paths on CPU.

The plain `soft_nms_reference` (what the wrapper runs for CPU tensors and
what the CUDA scan is held against on the card) against `soft_nms_pallas`
in interpret mode for the three methods; then the port's `soft_nms_fixed`,
`hard_nms_fixed`, `seg_voting`, `group_by_class`, `batched_nms` and
`postprocess_batch` against the JAX functions (vmapped over the videos).
Scores are distinct so that no order depends on a tie. Emitted scores
within rtol 1e-5 (the Gaussian's exp in another library), indices and
classes equal on slots whose score is more than 1e-6 from its neighbours',
valid slots exactly equal; voted segments within rtol 1e-5 (a weighted mean
summed in another order)."""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from unav_yolyolva_tpu.eval import decode as jdecode
from unav_yolyolva_tpu.ops import nms as jnms
from unav_yolyolva_tpu.ops.pallas_nms import soft_nms_pallas
from unav_yolyolva_tpu_torch.eval import decode as tdecode
from unav_yolyolva_tpu_torch.ops import nms as tnms
from unav_yolyolva_tpu_torch.ops.fused_nms import soft_nms, soft_nms_reference
from tests._torch_port_common import t
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)


def _candidates(seed, g, n, ncls=4, dead=0.2):
    """Segments, distinct positive scores, skewed classes (class 0 holds
    about 60%), a validity mask with some dead lanes and an empty last row."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(0, 40, size=(g, n))
    segs = np.stack([start, start + rng.uniform(0.5, 10, size=(g, n))], -1).astype(np.float32)
    scores = ((rng.permutation(g * n) + 1) / (g * n + 1)).reshape(g, n).astype(np.float32)
    cls = rng.choice(ncls, size=(g, n), p=[0.6] + [0.4 / (ncls - 1)] * (ncls - 1))
    valid = rng.uniform(size=(g, n)) >= dead
    valid[-1] = False
    return segs, scores, cls.astype(np.int32), valid


def _check_emissions(p_idx, p_sc, p_ok, r_idx, r_sc, r_ok):
    p_idx, p_sc, p_ok = (np.asarray(a) for a in (p_idx, p_sc, p_ok))
    r_idx, r_sc, r_ok = (np.asarray(a) for a in (r_idx, r_sc, r_ok))
    np.testing.assert_array_equal(p_ok, r_ok)
    np.testing.assert_allclose(p_sc, r_sc, rtol=1e-5, atol=1e-7)
    gap = np.full(r_sc.shape, np.inf)
    d = np.abs(np.diff(r_sc, axis=1))
    gap[:, 1:] = np.minimum(gap[:, 1:], d)
    gap[:, :-1] = np.minimum(gap[:, :-1], d)
    sure = gap > 1e-6
    np.testing.assert_array_equal(p_idx[sure], r_idx[sure])
    return sure


@pytest.mark.parametrize("method,max_out", [(0, 40), (1, 40), (2, 40), (2, 6)])
def test_soft_nms_plain_vs_pallas(method, max_out):
    segs, scores, _, valid = _candidates(method, g=11, n=96)   # 11 rows: not a row block
    scores = np.where(valid, scores, -np.inf).astype(np.float32)
    kw = dict(max_out=max_out, iou_threshold=0.4, sigma=0.5, min_score=0.05, method=method)
    ref = soft_nms_pallas(jnp.asarray(segs), jnp.asarray(scores), interpret=True,
                          row_block=8, **kw)
    out = soft_nms(t(segs), t(scores), **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, soft_nms_reference(t(segs), t(scores), **kw)))
    _check_emissions(*out, *ref)
    assert (out[0][-1] == -1).all() and (out[1][-1] == 0).all()   # the all-dead row


@pytest.mark.parametrize("kind,min_score", [("soft", 0.01), ("hard", 0.0), ("hard", 0.01)])
def test_soft_and_hard_nms_fixed(kind, min_score):
    segs, scores, _, valid = _candidates(5, g=5, n=80)
    if kind == "soft":
        jfn = functools.partial(jnms.soft_nms_fixed, max_out=30, iou_threshold=0.5,
                                sigma=0.5, min_score=min_score, method=jnms.NMS_GAUSSIAN)
        out = tnms.soft_nms_fixed(t(segs), t(scores), t(valid), 30, 0.5, 0.5, min_score)
    else:
        jfn = functools.partial(jnms.hard_nms_fixed, max_out=30, iou_threshold=0.5,
                                min_score=min_score)
        out = tnms.hard_nms_fixed(t(segs), t(scores), t(valid), 30, 0.5, min_score)
    ref = jax.vmap(jfn)(jnp.asarray(segs), jnp.asarray(scores), jnp.asarray(valid))
    _check_emissions(*out, *ref)
    # a dead slot points at candidate 0, as in the JAX package
    np.testing.assert_array_equal(out[0].numpy()[~out[2].numpy()], 0)


def test_seg_voting():
    segs, scores, _, valid = _candidates(6, g=3, n=60)
    rng = np.random.default_rng(7)
    kept = segs[:, :12] + rng.normal(size=(3, 12, 2)).astype(np.float32) * 0.3
    kept_ok = rng.uniform(size=(3, 12)) < 0.8
    ref = jax.vmap(lambda a, b, c, d, e: jnms.seg_voting(a, b, c, d, e, 0.6))(
        *map(jnp.asarray, (kept, kept_ok, segs, scores, valid)))
    out = tnms.seg_voting(*map(t, (kept, kept_ok, segs, scores, valid)), 0.6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [16, 64])
def test_group_by_class(m):
    segs, scores, cls, valid = _candidates(8, g=3, n=90)
    ref = jax.vmap(lambda a, b, c, d: jnms.group_by_class(a, b, c, d, 4, m))(
        *map(jnp.asarray, (segs, scores, cls, valid)))
    out = tnms.group_by_class(*map(t, (segs, scores, cls, valid)), 4, m)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("multiclass,soft,topk,voting", [
    (True, True, 64, 0.75), (True, True, 0, 0.75), (True, False, 64, 0.75),
    (True, False, 0, 0.0), (False, True, 64, 0.75), (False, True, 64, 0.0),
    (False, False, 64, 0.75)])
def test_batched_nms(multiclass, soft, topk, voting):
    segs, scores, cls, valid = _candidates(9, g=3, n=150)
    kw = dict(num_classes=4, iou_threshold=0.5, min_score=0.001, max_seg_num=30,
              use_soft_nms=soft, multiclass=multiclass, sigma=0.5, voting_thresh=voting,
              method=jnms.NMS_GAUSSIAN, per_class_topk=topk)
    ref = jax.vmap(functools.partial(jnms.batched_nms, **kw))(
        *map(jnp.asarray, (segs, scores, cls, valid)))
    out = tnms.batched_nms(*map(t, (segs, scores, cls, valid)), **kw)
    sure = _check_emissions(out[2], out[1], out[3], ref[2], ref[1], ref[3]) & np.asarray(ref[3])
    np.testing.assert_allclose(out[0].numpy()[sure], np.asarray(ref[0])[sure], rtol=1e-5,
                               atol=1e-5)
    assert out[3].numpy()[:2].any() and not out[3].numpy()[-1].any()


@pytest.mark.parametrize("method,multiclass", [("hard", True), ("soft", False),
                                               ("none", True)])
def test_postprocess_batch(method, multiclass):
    segs, scores, cls, valid = _candidates(10, g=3, n=120)
    test_cfg = {"nms_method": method, "multiclass_nms": multiclass, "iou_threshold": 0.5,
                "min_score": 0.001, "max_seg_num": 25, "nms_sigma": 0.5, "voting_thresh": 0.75}
    meta = {"fps": np.array([25.0, 30.0, 24.0], np.float32),
            "duration": np.array([20.0, 15.0, 30.0], np.float32),
            "feat_stride": np.array([8.0, 8.0, 16.0], np.float32),
            "num_frames": np.array([16.0, 16.0, 16.0], np.float32)}
    ref = jdecode.postprocess_batch(*map(jnp.asarray, (segs, scores, cls, valid)),
                                    num_classes=4, test_cfg=test_cfg,
                                    **{k: jnp.asarray(v) for k, v in meta.items()})
    out = tdecode.postprocess_batch(*map(t, (segs, scores, cls, valid)), num_classes=4,
                                    test_cfg=test_cfg, **{k: t(v) for k, v in meta.items()})
    sure = _check_emissions(out[2], out[1], out[3], ref[2], ref[1], ref[3]) & np.asarray(ref[3])
    np.testing.assert_allclose(out[0].numpy()[sure], np.asarray(ref[0])[sure], rtol=1e-5,
                               atol=1e-5)
