"""PyTorch port vs the JAX package: the candidate cap before NMS
(`tpu.nms_max_candidates`) and `tpu.approx_topk` (the exact top-k, as the
JAX decode's lax.approx_max_k computes it off the TPU), on CPU.

`decode_batch(max_candidates=k)` against the JAX `decode_single_video(
max_candidates=k)` (vmapped over the batch) on the same numpy inputs, with k
below, equal to and above the concatenated candidate count K, a planted
score tie, and every candidate tied across the cut: classes and validity
exact, segments and scores at rtol 1e-6. Then `make_eval_step` with the key set on a tiny model
against the JAX eval step's detections at the tolerances of
tests/test_torch_port_model.py's golden eval case."""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from unav_yolyolva_tpu.eval.decode import decode_single_video
from unav_yolyolva_tpu.geometry.points import generate_points as jgenerate_points
from unav_yolyolva_tpu_torch.eval import decode_batch
from unav_yolyolva_tpu_torch.geometry.points import generate_points
from tests._torch_port_common import lengths_mask, t
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)

B, T, NCLS = 3, 64, 5
REG_RANGE = [(0, 4), (4, 8), (8, 16), (16, 32), (32, 64), (64, 10000)]
DECODE = dict(pre_nms_thresh=0.001, pre_nms_topk=100, duration_thresh=0.05,
              class_aware=True)


def _head_outputs(seed):
    """Per-level logits, offsets and masks of a (B, T) batch, with a planted
    score tie between the first level and the last (equal logits, both
    valid, among the top scores)."""
    rng = np.random.default_rng(seed)
    mask = lengths_mask(B, T, [T, 37, 9])
    logits, offsets, masks = [], [], []
    for lvl in range(6):
        t_l = T >> lvl
        logits.append(rng.normal(-1.0, 2.0, size=(B, t_l, NCLS)).astype(np.float32))
        offsets.append(rng.uniform(0.1, 3.0, size=(B, t_l, NCLS, 2)).astype(np.float32))
        masks.append(mask[:, ::1 << lvl][:, :t_l])
    logits[5][:, 0, 2] = logits[0][:, 3, 1] = 6.0
    return logits, offsets, masks


def _jax_decode(logits, offsets, masks, points, k):
    pts = [jnp.asarray(p) for p in points]
    fn = functools.partial(decode_single_video, points=pts, max_candidates=k, **DECODE)
    return [np.asarray(a) for a in jax.vmap(
        lambda c, o, m: fn(c, o, m))([jnp.asarray(a) for a in logits],
                                     [jnp.asarray(a) for a in offsets],
                                     [jnp.asarray(a) for a in masks])]


@pytest.mark.parametrize("k", [0, 120, 350, 500])
def test_decode_cap_matches_jax(k):
    """K = 100 + 100 + 80 + 40 + 20 + 10 = 350 candidates: 120 cuts them,
    350 and 500 keep all (in the concatenation's order), 0 is off."""
    logits, offsets, masks = _head_outputs(7)
    points = generate_points(T, REG_RANGE, 2)
    ref = _jax_decode(logits, offsets, masks, jgenerate_points(T, REG_RANGE, 2), k)
    got = decode_batch([t(a) for a in logits], [t(a) for a in offsets],
                       [t(a) for a in masks], [t(p) for p in points],
                       max_candidates=k, **DECODE)
    assert got[1].shape == (B, 120 if k == 120 else 350)
    np.testing.assert_array_equal(got[2].numpy(), ref[2])           # classes
    np.testing.assert_array_equal(got[3].numpy(), ref[3])           # valid
    np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=1e-6)   # segments
    np.testing.assert_allclose(got[1].numpy(), ref[1], rtol=1e-6)   # scores
    if k == 120:                   # the planted tie survives the cut, in index order
        tie = float(torch.sigmoid(torch.tensor(6.0)))
        at = torch.nonzero((got[1][0] - tie).abs() < 1e-7).flatten()
        assert at.numel() == 2 and got[2][0, at].tolist() == [1, 2]


def test_decode_cap_ranks_ties_by_index():
    """Equal scores across the cut keep the lower concatenation index, as
    lax.top_k does: a stable descending sort, not torch.topk."""
    logits, offsets, masks = _head_outputs(8)
    for a in logits:
        a[:] = 0.0                             # every valid candidate ties at 0.5
    points = generate_points(T, REG_RANGE, 2)
    ref = _jax_decode(logits, offsets, masks, jgenerate_points(T, REG_RANGE, 2), 60)
    got = decode_batch([t(a) for a in logits], [t(a) for a in offsets],
                       [t(a) for a in masks], [t(p) for p in points],
                       max_candidates=60, **DECODE)
    for i in range(4):
        np.testing.assert_array_equal(got[i].numpy(), ref[i])


@pytest.fixture(scope="module")
def tiny_models():
    """The JAX model and state at a tiny config with nms_max_candidates set,
    and the port with the same weights."""
    from unav_yolyolva_tpu.core.config import load_config_dict as jcfg
    from unav_yolyolva_tpu.models import build_model as jbuild
    from unav_yolyolva_tpu.train import create_train_state
    from unav_yolyolva_tpu.train.optim import make_optimizer
    from unav_yolyolva_tpu_torch.core import load_config_dict
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.utils.convert import params_from_jax
    from tests._torch_port_common import np_tree

    over = {
        "dataset": {"num_classes": NCLS, "max_seq_len": T, "max_num_events": 8},
        "model": {"raw_input_dim_V": 64, "raw_input_dim_A": 16, "input_dim_V": 32,
                  "input_dim_A": 32, "embd_dim": 32, "head_dim": 32,
                  "use_abs_pe": True, "class_aware": True},
        "train_cfg": {"loss_weight": 1},
        "test_cfg": {"pre_nms_topk": 100, "max_seg_num": 20, "min_score": 0.001,
                     "nms_sigma": 0.4, "iou_threshold": 0.7},
        "tpu": {"nms_max_candidates": 120},
    }
    jmodel = jbuild(jcfg(over))
    dummy = {"visual": jnp.zeros((2, T, 64)), "audio": jnp.zeros((2, T, 16)),
             "mask": jnp.ones((2, T), bool), "m_scores": jnp.zeros((2, T)),
             "m_start_end": jnp.zeros((2, T)), "m_labels": jnp.zeros((2, T, NCLS))}
    params = jax.jit(lambda k, d: jmodel.init({"params": k, "droppath": k}, d, train=False))(
        jax.random.PRNGKey(3), dummy)
    tx, _ = make_optimizer(params, jcfg(over)["opt"], 1)
    state = create_train_state(params, tx, 100.0)
    cfg = load_config_dict(over)
    port = build_model(cfg, device="cpu", seed=None)
    port.load_state_dict(params_from_jax(np_tree(params)), strict=True)
    return jmodel, state, jcfg(over), port, cfg


def test_eval_step_with_the_cap_matches_jax(tiny_models):
    from unav_yolyolva_tpu.train import make_eval_step as jmake_eval_step
    from unav_yolyolva_tpu_torch.eval import make_eval_step

    jmodel, state, jcfg, port, cfg = tiny_models
    rng = np.random.default_rng(9)
    mask = lengths_mask(2, T, [T, 41])
    batch = {"visual": rng.normal(size=(2, T, 64)).astype(np.float32) * mask[..., None],
             "audio": rng.normal(size=(2, T, 16)).astype(np.float32) * mask[..., None],
             "mask": mask,
             "fps": np.full(2, 25.0, np.float32),
             "duration": np.array([T, 41], np.float32) * 8 / 25,
             "feat_stride": np.full(2, 8.0, np.float32),
             "feat_num_frames": np.full(2, 24.0, np.float32),
             "gt_segments": np.zeros((2, 8, 2), np.float32),
             "gt_labels": np.zeros((2, 8), np.int32),
             "gt_valid": np.zeros((2, 8), bool)}
    ref, _ = jmake_eval_step(jmodel, jcfg, use_ema=True, with_losses=False)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = make_eval_step(port, cfg, device="cpu")(batch)
    got = {k: v.numpy() for k, v in got.items()}
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    ok = ref["valid"].astype(bool)
    assert ok.sum() > 0
    np.testing.assert_array_equal(got["labels"][ok], ref["labels"][ok])
    np.testing.assert_allclose(got["segments"][ok], ref["segments"][ok], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["scores"][ok], ref["scores"][ok], rtol=1e-4, atol=1e-5)


def test_approx_topk_is_refused():
    """tpu.approx_topk, once refused, is the exact top-k (the eval step with
    the flag: test_eval_step_with_approx_topk_matches_jax). Off the TPU the
    JAX decode's lax.approx_max_k IS the exact top-k: its candidates with
    the flag on are bit-identical to those with it off, and the port's
    decode equals them (classes and validity exact, segments and scores
    rtol 1e-6, as test_decode_cap_matches_jax)."""
    logits, offsets, masks = _head_outputs(11)
    jpts = [jnp.asarray(p) for p in jgenerate_points(T, REG_RANGE, 2)]
    args = ([jnp.asarray(a) for a in logits], [jnp.asarray(a) for a in offsets],
            [jnp.asarray(a) for a in masks])
    exact, approx = (
        [np.asarray(a) for a in jax.vmap(functools.partial(
            decode_single_video, points=jpts, approx_topk=flag, **DECODE))(*args)]
        for flag in (False, True))
    for a, b in zip(exact, approx):
        assert a.tobytes() == b.tobytes()
    got = decode_batch([t(a) for a in logits], [t(a) for a in offsets],
                       [t(a) for a in masks], [t(p) for p in generate_points(T, REG_RANGE, 2)],
                       **DECODE)
    np.testing.assert_array_equal(got[2].numpy(), approx[2])
    np.testing.assert_array_equal(got[3].numpy(), approx[3])
    np.testing.assert_allclose(got[0].numpy(), approx[0], rtol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), approx[1], rtol=1e-6)


def test_eval_step_with_approx_topk_matches_jax(tiny_models):
    """make_eval_step with tpu.approx_topk True (and the cap) against the
    JAX eval step with the flag on: validity and labels exact, segments
    and scores at tests/test_torch_port_model.py's golden eval tolerances."""
    import copy

    from unav_yolyolva_tpu.train import make_eval_step as jmake_eval_step
    from unav_yolyolva_tpu_torch.eval import make_eval_step

    jmodel, state, jcfg, port, cfg = tiny_models
    jcfg, cfg = copy.deepcopy(jcfg), copy.deepcopy(cfg)
    jcfg["tpu"]["approx_topk"] = cfg["tpu"]["approx_topk"] = True
    rng = np.random.default_rng(10)
    mask = lengths_mask(2, T, [T, 50])
    batch = {"visual": rng.normal(size=(2, T, 64)).astype(np.float32) * mask[..., None],
             "audio": rng.normal(size=(2, T, 16)).astype(np.float32) * mask[..., None],
             "mask": mask,
             "fps": np.full(2, 25.0, np.float32),
             "duration": np.array([T, 50], np.float32) * 8 / 25,
             "feat_stride": np.full(2, 8.0, np.float32),
             "feat_num_frames": np.full(2, 24.0, np.float32),
             "gt_segments": np.zeros((2, 8, 2), np.float32),
             "gt_labels": np.zeros((2, 8), np.int32),
             "gt_valid": np.zeros((2, 8), bool)}
    ref, _ = jmake_eval_step(jmodel, jcfg, use_ema=True, with_losses=False)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: v.numpy() for k, v in make_eval_step(port, cfg, device="cpu")(batch).items()}
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    ok = ref["valid"].astype(bool)
    assert ok.sum() > 0
    np.testing.assert_array_equal(got["labels"][ok], ref["labels"][ok])
    np.testing.assert_allclose(got["segments"][ok], ref["segments"][ok], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["scores"][ok], ref["scores"][ok], rtol=1e-4, atol=1e-5)
