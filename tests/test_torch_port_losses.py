"""PyTorch port vs the JAX package: the train path's host-free pieces on CPU.

Losses (focal, DIoU, DIoU pair weights), label assignment and per-frame
targets, the LR schedule, the weight-decay partition, the EMA update,
stochastic depth and the epoch-average loss tracking. The same seeded numpy
inputs go through both packages. Tolerances: rtol 1e-4 / atol 1e-5 for
fp32 with another summation order, exact for integer-valued targets."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from unav_yolyolva_tpu.geometry import assign as jassign
from unav_yolyolva_tpu.geometry.points import concat_points, generate_points
from unav_yolyolva_tpu.ops import losses as jl
from unav_yolyolva_tpu.train import optim as joptim
from unav_yolyolva_tpu.train.ema import ema_update as jema_update
from unav_yolyolva_tpu_torch.geometry import assign as tassign
from unav_yolyolva_tpu_torch.models.blocks import AffineDropPath, drop_path
from unav_yolyolva_tpu_torch.ops import losses as tl
from unav_yolyolva_tpu_torch.train import optim as toptim
from unav_yolyolva_tpu_torch.train.ema import ema_update
from unav_yolyolva_tpu_torch.train.loop import train_one_epoch
from tests._torch_port_common import close, t
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)

REG_RANGE = [(0, 4), (4, 8), (8, 16), (16, 32), (32, 64), (64, 10000)]


@pytest.mark.parametrize("alpha,reduction", [(0.25, "none"), (-1.0, "sum"), (0.25, "mean")])
def test_sigmoid_focal_loss(alpha, reduction):
    rng = np.random.default_rng(30)
    x = (rng.normal(size=(3, 50, 7)) * 4).astype(np.float32)
    y = (rng.uniform(size=(3, 50, 7)) < 0.2).astype(np.float32)
    w = (rng.uniform(size=(3, 50, 1)) < 0.8).astype(np.float32)
    ref = jl.sigmoid_focal_loss(jnp.asarray(x), jnp.asarray(y), alpha=alpha,
                                reduction=reduction, weights=jnp.asarray(w))
    out = tl.sigmoid_focal_loss(t(x), t(y), alpha=alpha, reduction=reduction, weights=t(w))
    close(out, ref)


@pytest.mark.parametrize("reduction", ["none", "sum"])
def test_ctr_diou_loss_and_pair_weights(reduction):
    rng = np.random.default_rng(31)
    pred = np.abs(rng.normal(size=(2, 40, 5, 2)) * 3).astype(np.float32)
    tgt = np.abs(rng.normal(size=(2, 40, 5, 2)) * 3).astype(np.float32)
    tgt[rng.uniform(size=(2, 40, 5)) < 0.5] = 0.0
    tgt[0, 0, 0] = [0.0, 1.5]                                # one side only
    wj = jl.diou_pair_weights(jnp.asarray(tgt))
    wt = tl.diou_pair_weights(t(tgt))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    ref = jl.ctr_diou_loss_1d(jnp.asarray(pred), jnp.asarray(tgt), reduction=reduction,
                              weights=wj)
    close(tl.ctr_diou_loss_1d(t(pred), t(tgt), reduction=reduction, weights=wt), ref)


def _events(seed, b=4, n=6, length=64, ncls=5):
    rng = np.random.default_rng(seed)
    start = rng.uniform(-3, length - 4, size=(b, n)).astype(np.float32)
    width = rng.uniform(0.5, length / 2, size=(b, n)).astype(np.float32)
    segs = np.stack([start, start + width], -1).astype(np.float32)
    segs[0, 1] = segs[0, 0]                                    # a duplicate event
    labels = rng.integers(0, ncls, size=(b, n)).astype(np.int32)
    labels[0, 1] = labels[0, 0]
    valid = np.arange(n)[None, :] < rng.integers(0, n + 1, size=(b, 1))
    valid[0, :2] = True
    return segs, labels, valid


@pytest.mark.parametrize("class_aware,seed", [(True, 0), (True, 1), (False, 2)])
def test_assign_labels_batch(class_aware, seed):
    segs, labels, valid = _events(40 + seed)
    pts = concat_points(generate_points(64, REG_RANGE, 2))
    jc, jr = jassign.assign_labels_batch(jnp.asarray(pts), jnp.asarray(segs),
                                         jnp.asarray(labels), jnp.asarray(valid), 5,
                                         class_aware)
    tc, tr = tassign.assign_labels_batch(t(pts), t(segs), t(labels), t(valid), 5,
                                         class_aware)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    close(tr, jr, rtol=1e-6, atol=1e-6)
    assert tc.sum() > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_frame_targets_batch(seed):
    segs, labels, valid = _events(50 + seed)
    ref = jassign.frame_targets_batch(jnp.asarray(segs), jnp.asarray(labels),
                                      jnp.asarray(valid), 64, 5)
    out = tassign.frame_targets_batch(t(segs), t(labels), t(valid), 64, 5)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    assert out[0].sum() > 0
    assert tassign.FRAME_TARGET_DIVISOR == jassign.FRAME_TARGET_DIVISOR == 1.28


def _opt_cfg(**kw):
    base = {"learning_rate": 1e-4, "epochs": 40, "warmup": True, "warmup_epochs": 5,
            "schedule_type": "cosine", "schedule_steps": [], "schedule_gamma": 0.1,
            "eta_min": 1e-8}
    base.update(kw)
    return base


@pytest.mark.parametrize("kw", [{}, {"schedule_type": "multistep", "schedule_steps": [2, 5]},
                                {"warmup_epochs": 1, "epochs": 2}])
def test_make_schedule(kw):
    iters = 7
    ref = joptim.make_schedule(_opt_cfg(**kw), iters)
    out = toptim.make_schedule(_opt_cfg(**kw), iters)
    steps = [0, 1, 2, 5, 6, 7, 20, 34, 35, 36, 100, 200, 314, 315, 400]
    np.testing.assert_allclose([out(s) for s in steps], [float(ref(s)) for s in steps],
                               rtol=1e-6, atol=1e-12)
    assert out(0) == 0.0


def test_decay_mask_matches_jax(golden_params):
    jmodel_params, port = golden_params
    ref = joptim.decay_mask(jmodel_params)
    from unav_yolyolva_tpu_torch.utils.convert import build_key_map

    flax = {k: p for k, p, _ in build_key_map((2, 3, 5), True)}
    mask = toptim.decay_mask(port)
    assert set(mask) == {n for n, _ in port.named_parameters()}
    for name, decays in mask.items():
        node = ref["params"]
        for p in flax[name]:
            node = node[p]
        assert decays == bool(node), name
    # the reference quirks: the alignment decays its LayerNorm scales and
    # embeddings, the contrastive logit scales never decay
    assert mask["alignment.norm_video.weight"] and mask["alignment.pos_embed_video"]
    assert not mask["alignment.norm_video.bias"]
    assert not mask["contrastive_losses.logit_scale_inter"]
    assert not mask["backbone.self_att_V.0.ln11.weight"]
    assert mask["backbone.fusion_module.match_projection.weight"]


@pytest.fixture(scope="module")
def golden_params():
    """JAX params of the golden config (droppath on) and the port with them."""
    from unav_yolyolva_tpu.core.config import load_config_dict as jcfg
    from unav_yolyolva_tpu.models import build_model as jbuild
    from unav_yolyolva_tpu_torch.core import load_config_dict
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.utils.convert import params_from_jax
    from tests._torch_port_common import np_tree

    over = {"dataset": {"num_classes": 5, "max_seq_len": 64},
            "model": {"raw_input_dim_V": 64, "raw_input_dim_A": 16, "input_dim_V": 32,
                      "input_dim_A": 32, "embd_dim": 32, "head_dim": 32, "use_abs_pe": True}}
    jmodel = jbuild(jcfg(over))
    dummy = {"visual": jnp.zeros((2, 64, 64)), "audio": jnp.zeros((2, 64, 16)),
             "mask": jnp.ones((2, 64), bool), "m_scores": jnp.zeros((2, 64)),
             "m_start_end": jnp.zeros((2, 64)), "m_labels": jnp.zeros((2, 64, 5))}
    params = np_tree(jax.jit(lambda k, d: jmodel.init(
        {"params": k, "droppath": k}, d, train=False))(jax.random.PRNGKey(0), dummy))
    port = build_model(load_config_dict(over), device="cpu", seed=None)
    port.load_state_dict(params_from_jax(params), strict=True)
    return params, port


def test_ema_update_matches_jax():
    rng = np.random.default_rng(32)
    e = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (5,))]
    p = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (5,))]
    ref = jema_update([jnp.asarray(x) for x in e], [jnp.asarray(x) for x in p])
    ema, model = torch.nn.ParameterList(map(t, e)), torch.nn.ParameterList(map(t, p))
    ema_update(ema, model)
    for o, r in zip(ema, ref):
        close(o, r, rtol=1e-6, atol=1e-7)


def test_drop_path_is_per_sample_seeded_and_train_only():
    x = torch.ones(64, 5, 8)
    a = drop_path(x, 0.25, torch.Generator().manual_seed(3))
    b = drop_path(x, 0.25, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    per_row = a[:, 0, 0]
    assert set(per_row.unique().tolist()) == {0.0, float(torch.tensor(1.0) / 0.75)}
    assert (a == per_row[:, None, None]).all()                # one draw per sample
    assert 0 < int((per_row == 0).sum()) < 64
    mod = AffineDropPath(8, 0.25)
    with torch.no_grad():
        mod.scale.fill_(2.0)
    mod.eval()
    assert torch.equal(mod(x), 2 * x)                         # no draw in eval
    mod.train()
    assert torch.equal(mod(x, torch.Generator().manual_seed(3)), 2 * a)
    with pytest.raises(ValueError):
        mod(x)


def test_train_one_epoch_averages_tracked_losses():
    """Losses are sampled every print_freq steps and at the last step, each
    once, and the epoch value is their average."""
    class State:
        step = 0

    def step_fn(state, batch, seed):
        state.step += 1
        return {"final_loss": torch.tensor(float(batch))}

    for n, expect in ((5, (2 + 4) / 2), (6, (2 + 4 + 5) / 3), (1, 0.0)):
        state, losses = train_one_epoch(State(), range(n), step_fn, 0, 0, print_freq=2,
                                        log=lambda *a: None)
        assert losses["final_loss"] == expect and state.step == n
