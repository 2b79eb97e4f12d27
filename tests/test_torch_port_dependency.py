"""PyTorch port vs the JAX package: the dependency block (`use_dependency:
True`) on CPU.

  * TransformerBlock with n_hidden = n_embd (the block's hidden width);
  * DependencyBlock at tests/test_dependency.py's shapes (B=2, T=16,
    C_in=16, n_embd 8, 5 classes, a padded tail on one sample, two levels):
    forward at rtol 1e-5 / atol 1e-6, input and parameter grads at the
    train path's tolerances (tests/test_torch_port_train.py);
  * the whole detector with use_dependency at a small width: the eval
    step's detections against the JAX eval step's (rtol 1e-4, as
    tests/test_torch_port_decode_cap.py) and one train step's grads
    against jax.grad of the JAX loss.
The JAX MHCA runs its Pallas kernels in interpret mode, as the JAX
package's own tests run them on the CPU."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from unav_yolyolva_tpu.models import blocks as jb
from unav_yolyolva_tpu.models.dependency import DependencyBlock as JDependencyBlock
from unav_yolyolva_tpu_torch.models import blocks as tb
from unav_yolyolva_tpu_torch.models.dependency import DependencyBlock
from unav_yolyolva_tpu_torch.utils.convert import dependency_entries, tblock_entries
from tests._torch_port_common import close, lengths_mask, load_port, np_tree, t
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)

B, T, CIN, H, NCLS = 2, 16, 16, 8, 5


def assert_grads_close(name, got, ref):
    """The train path's gate: norm-wise <= 1e-4, elementwise rtol 1e-3 with
    an atol of 1e-4 x the tensor's largest grad."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.isfinite(got).all(), name
    err = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)
    assert err <= 1e-4, (name, err)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4 * np.abs(ref).max(),
                               err_msg=name)


@pytest.mark.parametrize("pdrop", [0.1, 0.0])
def test_transformer_block_with_n_hidden(pdrop):
    """n_hidden = n_embd, one head of width C, a row without a valid frame."""
    c = 16
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 24, c)).astype(np.float32)
    mask = lengths_mask(3, 24, [24, 9, 0])
    jmod = jb.TransformerBlock(c, 1, n_hidden=c, path_pdrop=pdrop)
    params = np_tree(jmod.init(jax.random.PRNGKey(4), x, x, mask))["params"]
    assert params["mlp_fc1"]["kernel"].shape == (c, c)
    if pdrop:
        for k in ("drop_path_attn", "drop_path_mlp"):
            params[k]["scale"] = np.full_like(params[k]["scale"], 0.7)
    ref, _ = jmod.apply({"params": params}, x, x, mask, train=False)
    port = load_port(tb.TransformerBlock(c, 1, path_pdrop=pdrop, n_hidden=c),
                     tblock_entries("b", (), pdrop > 0), params, "b.")
    assert port.mlp[0].weight.shape == (c, c, 1)
    with torch.no_grad():
        out, _ = port(t(x), t(x), t(mask))
    close(out, ref)
    # the default hidden width stays 4 * n_embd, under the same key names
    assert tb.TransformerBlock(c, 1).mlp[0].weight.shape == (4 * c, c, 1)


def _block_inputs():
    """tests/test_dependency.py's inputs: two levels, a padded tail on
    sample 1."""
    rng = np.random.default_rng(0)
    feats = [rng.normal(size=(B, T, CIN)).astype(np.float32),
             rng.normal(size=(B, T // 2, CIN)).astype(np.float32)]
    masks = []
    for t_l in (T, T // 2):
        m = np.zeros((B, t_l), bool)
        m[0, :] = True
        m[1, : max(1, t_l - 5)] = True
        masks.append(m)
    return feats, masks


@pytest.fixture(scope="module")
def blocks():
    """The JAX block with PRNGKey(0) weights (droppath scales at 0.7, so that
    both branches count) and the port with the same weights."""
    jblock = JDependencyBlock(in_channel=CIN, n_embd=H, n_embd_ks=3, num_classes=NCLS,
                              path_pdrop=0.1, n_head=1)
    feats, masks = _block_inputs()
    params = np_tree(jblock.init({"params": jax.random.PRNGKey(0),
                                  "droppath": jax.random.PRNGKey(0)},
                                 feats, masks, train=False))["params"]
    for br in ("temporal_branch", "cooccur_branch"):
        for k in ("drop_path_attn", "drop_path_mlp"):
            params[br][k]["scale"] = np.full_like(params[br][k]["scale"], 0.7)
    port = load_port(DependencyBlock(CIN, H, 3, NCLS, path_pdrop=0.1, n_head=1),
                     dependency_entries(True), {"dependency": params}, "dependency.")
    return jblock, params, port


def test_dependency_block_forward(blocks):
    jblock, params, port = blocks
    feats, masks = _block_inputs()
    ref, ref_m = jblock.apply({"params": params}, feats, masks, train=False)
    with torch.no_grad():
        got, got_m = port([t(f) for f in feats], [t(m) for m in masks])
    for lvl in range(2):
        close(got[lvl], ref[lvl], rtol=1e-5, atol=1e-6)
        assert got[lvl].shape == (B, feats[lvl].shape[1], CIN)
        np.testing.assert_array_equal(got_m[lvl].numpy(), masks[lvl])
        assert (got[lvl].numpy()[~masks[lvl]] == 0).all()


def test_dependency_block_grads(blocks):
    """Grads of sum(out ** 2) over both levels: the inputs' and every
    parameter's, through the JAX custom VJPs (the Pallas MHCA backward in
    interpret mode) and the port's autograd of its plain versions."""
    jblock, params, port = blocks
    feats, masks = _block_inputs()

    def loss(p, fs):
        out, _ = jblock.apply({"params": p}, fs, masks, train=False)
        return sum(jnp.sum(x * x) for x in out)

    g_params, g_feats = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        params, [jnp.asarray(f) for f in feats])
    xs = [t(f).requires_grad_(True) for f in feats]
    out, _ = port(xs, [t(m) for m in masks])
    sum((o * o).sum() for o in out).backward()
    for lvl in range(2):
        assert_grads_close(f"feats[{lvl}]", xs[lvl].grad.numpy(), g_feats[lvl])
    ref = {k[len("dependency."):]: v.numpy() for k, v in _entries_sd(g_params).items()}
    zero = 1e-6 * max(np.linalg.norm(g) for g in ref.values())
    for name, p in port.named_parameters():
        if np.linalg.norm(ref[name]) < zero:
            # a bias of k (or of its LayerNorm) shifts every logit of a row
            # alike; softmax cancels it, so the exact grad is 0 and both
            # packages hold rounding noise only
            assert np.linalg.norm(p.grad.numpy()) < zero, name
            continue
        assert_grads_close(name, p.grad.numpy(), ref[name])


def _entries_sd(tree):
    from unav_yolyolva_tpu_torch.utils.convert import state_dict_from_entries

    return state_dict_from_entries(dependency_entries(True),
                                   {"dependency": jax.tree.map(np.asarray, tree)})


# ---- the whole detector with use_dependency ---------------------------------

TM, NE = 64, 8
OVER = {
    "dataset": {"num_classes": NCLS, "max_seq_len": TM, "max_num_events": NE},
    "model": {"raw_input_dim_V": 64, "raw_input_dim_A": 16, "input_dim_V": 32,
              "input_dim_A": 32, "embd_dim": 32, "head_dim": 32, "use_abs_pe": True,
              "class_aware": True, "use_dependency": True},
    "train_cfg": {"loss_weight": 1, "droppath": 0.0},
    "test_cfg": {"pre_nms_topk": 100, "max_seg_num": 20, "min_score": 0.001,
                 "nms_sigma": 0.4, "iou_threshold": 0.7},
}


@pytest.fixture(scope="module")
def models():
    from unav_yolyolva_tpu.core.config import load_config_dict as jcfg
    from unav_yolyolva_tpu.models import build_model as jbuild
    from unav_yolyolva_tpu.train import create_train_state
    from unav_yolyolva_tpu.train.optim import make_optimizer
    from unav_yolyolva_tpu_torch.core import load_config_dict
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.utils.convert import params_from_jax

    jc = jcfg(OVER)
    jmodel = jbuild(jc)
    dummy = {"visual": jnp.zeros((2, TM, 64)), "audio": jnp.zeros((2, TM, 16)),
             "mask": jnp.ones((2, TM), bool), "m_scores": jnp.zeros((2, TM)),
             "m_start_end": jnp.zeros((2, TM)), "m_labels": jnp.zeros((2, TM, NCLS))}
    params = np_tree(jax.jit(lambda k, d: jmodel.init(
        {"params": k, "droppath": k}, d, train=False))(jax.random.PRNGKey(5), dummy))
    assert "dependency" in params["params"]
    tx, _ = make_optimizer(params, jc["opt"], 1)
    state = create_train_state(params, tx, 100.0)
    cfg = load_config_dict(OVER)
    port = build_model(cfg, device="cpu", seed=None)
    port.load_state_dict(params_from_jax(params), strict=True)
    return jmodel, params, state, jc, port, cfg


def _batch(seed):
    rng = np.random.default_rng(seed)
    mask = lengths_mask(2, TM, [TM, 41])
    starts = rng.uniform(0, 30, size=(2, NE)).astype(np.float32)
    segs = np.stack([starts, starts + rng.uniform(2, 20, size=(2, NE))], -1)
    valid = np.arange(NE)[None, :] < np.array([[3], [2]])
    return {"visual": (rng.normal(size=(2, TM, 64)) * mask[..., None]).astype(np.float32),
            "audio": (rng.normal(size=(2, TM, 16)) * mask[..., None]).astype(np.float32),
            "mask": mask, "fps": np.full(2, 25.0, np.float32),
            "duration": np.array([TM, 41], np.float32) * 8 / 25,
            "feat_stride": np.full(2, 8.0, np.float32),
            "feat_num_frames": np.full(2, 24.0, np.float32),
            "gt_segments": (segs * valid[..., None]).astype(np.float32),
            "gt_labels": (rng.integers(0, NCLS, size=(2, NE)) * valid).astype(np.int32),
            "gt_valid": valid}


def test_detector_with_dependency_eval_step_matches_jax(models):
    from unav_yolyolva_tpu.train import make_eval_step as jmake_eval_step
    from unav_yolyolva_tpu_torch.eval import make_eval_step

    jmodel, _, state, jc, port, cfg = models
    batch = _batch(11)
    ref, _ = jmake_eval_step(jmodel, jc, use_ema=True, with_losses=False)(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: v.numpy() for k, v in make_eval_step(port, cfg, device="cpu")(batch).items()}
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    ok = ref["valid"].astype(bool)
    assert ok.sum() > 0
    np.testing.assert_array_equal(got["labels"][ok], ref["labels"][ok])
    np.testing.assert_allclose(got["segments"][ok], ref["segments"][ok], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["scores"][ok], ref["scores"][ok], rtol=1e-4, atol=1e-5)


def test_detector_with_dependency_train_grads_match_jax(models):
    """One step's grads of every parameter, the dependency block's among
    them, against jax.grad of the JAX loss (droppath 0 in both): the gate
    of tests/test_torch_port_train.py:test_train_step_gradients."""
    from unav_yolyolva_tpu.geometry.points import concat_points as jconcat
    from unav_yolyolva_tpu.geometry.points import generate_points as jgen
    from unav_yolyolva_tpu.models.meta_arch import compute_losses as jcompute
    from unav_yolyolva_tpu.train.step import _loss_kwargs, build_targets as jtargets
    from unav_yolyolva_tpu_torch.geometry.points import concat_points, generate_points
    from unav_yolyolva_tpu_torch.models.meta_arch import compute_losses
    from unav_yolyolva_tpu_torch.train.step import build_targets, loss_kwargs
    from unav_yolyolva_tpu_torch.utils.convert import jax_key_map, state_dict_from_entries

    jmodel, params, _, jc, port, cfg = models
    batch = {k: v for k, v in _batch(12).items()
             if k in ("visual", "audio", "mask", "gt_segments", "gt_labels", "gt_valid")}
    pts = jnp.asarray(jconcat(jgen(TM, jc["model"]["regression_range"], 2)))
    ms, mse, ml, gcls, greg = jtargets({k: jnp.asarray(v) for k, v in batch.items()}, pts,
                                       TM, NCLS, True)
    inputs = {"visual": batch["visual"], "audio": batch["audio"], "mask": batch["mask"],
              "m_scores": ms, "m_start_end": mse, "m_labels": ml}

    def loss_fn(p):
        out = jmodel.apply(p, inputs, train=True, rngs={"droppath": jax.random.PRNGKey(1)})
        return jcompute(out, gcls, greg, jnp.asarray(100.0), **_loss_kwargs(jc))[0]["final_loss"]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    ref_grads = state_dict_from_entries(jax_key_map(params),
                                        jax.tree.map(np.asarray, ref_grads["params"]))

    port = port.train()
    tb_ = {k: t(v) for k, v in batch.items()}
    tpts = t(concat_points(generate_points(TM, cfg["model"]["regression_range"], 2)))
    tms, tmse, tml, tcls, treg = build_targets(tb_, tpts, TM, NCLS, True)
    out = port({"visual": tb_["visual"], "audio": tb_["audio"], "mask": tb_["mask"],
                "m_scores": tms, "m_start_end": tmse, "m_labels": tml})
    loss = compute_losses(out, tcls, treg, torch.tensor(100.0), **loss_kwargs(cfg))[0]
    port.zero_grad()
    loss["final_loss"].backward()
    port.eval()
    close(loss["final_loss"], ref_loss, rtol=2e-4)
    zero = 1e-6 * max(np.linalg.norm(g.numpy()) for g in ref_grads.values())
    dep = 0
    for name, p in port.named_parameters():
        ref = ref_grads[name].numpy()
        if p.grad is None:
            assert not ref.any(), name
            continue
        g = p.grad.numpy()
        if np.linalg.norm(ref) < zero:       # zero in exact arithmetic (softmax shift)
            assert np.linalg.norm(g) < zero, name
            continue
        assert_grads_close(name, g, ref)
        dep += name.startswith("dependency.")
    assert dep >= 20


def test_detector_with_dependency_decay_mask_is_the_jax_one(models):
    """Weight decay on every parameter, the block's among them, as the JAX
    decay_mask gives it."""
    from unav_yolyolva_tpu.train.optim import decay_mask as jdecay_mask
    from unav_yolyolva_tpu_torch.train import decay_mask
    from unav_yolyolva_tpu_torch.utils.convert import jax_key_map

    _, params, _, _, port, _ = models
    ref = jdecay_mask(params)
    got = decay_mask(port)
    dep = 0
    for key, path, _ in jax_key_map(params):
        node = ref
        for p in ("params",) + path:
            node = node[p]
        assert got[key] == bool(node), key
        dep += key.startswith("dependency.") and got[key]
    # expand, squeeze, and per branch 3 depthwise + 4 dense MHCA kernels and 2 MLP kernels
    assert set(got) == {k for k, _, _ in jax_key_map(params)} and dep == 2 + 2 * 9


def test_reference_checkpoint_with_dependency_keys_is_refused():
    from unav_yolyolva_tpu_torch.utils.convert import state_dict_from_reference

    with pytest.raises(ValueError, match="dependency"):
        state_dict_from_reference({"module.dependency_block.feature_expand.conv.weight":
                                   torch.zeros(4, 2, 3)})
