"""PyTorch port vs the JAX package: the train path on CPU.

  * compute_losses at the golden config, with the loss-normalizer EMA;
  * one whole train step's gradients at the golden config, droppath 0 in
    both packages, every parameter through the key map;
  * a 3-step trajectory of make_train_step against the JAX make_train_step
    with flat_adamw; a checkpoint round trip that resumes to the same step.
Tolerances are stated at each comparison."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tests._torch_port_common import close, lengths_mask, t
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---- the whole model at the golden config ----------------------------------

B, T, NCLS, NE = 2, 64, 5, 8
LR = 1e-3
OVER = {
    "dataset": {"num_classes": NCLS, "max_seq_len": T, "max_num_events": NE},
    "model": {"raw_input_dim_V": 64, "raw_input_dim_A": 16, "input_dim_V": 32,
              "input_dim_A": 32, "embd_dim": 32, "head_dim": 32, "use_abs_pe": True,
              "class_aware": True},
    "opt": {"learning_rate": LR, "weight_decay": 1e-4, "epochs": 2, "warmup_epochs": 1},
    "train_cfg": {"loss_weight": 1, "droppath": 0.0},
}
ITERS = 2     # iterations per epoch of the schedule: lr 0, LR, LR, ...


def _train_batch(seed):
    rng = np.random.default_rng(seed)
    mask = lengths_mask(B, T, [T, 45])
    m = mask[..., None].astype(np.float32)
    starts = rng.uniform(0, 40, size=(B, NE)).astype(np.float32)
    segs = np.stack([starts, starts + rng.uniform(2, 24, size=(B, NE))], -1)
    valid = np.arange(NE)[None, :] < np.array([[3], [2]])
    return {"visual": (rng.normal(size=(B, T, 64)) * m).astype(np.float32),
            "audio": (rng.normal(size=(B, T, 16)) * m).astype(np.float32),
            "mask": mask,
            "gt_segments": (segs * valid[..., None]).astype(np.float32),
            "gt_labels": (rng.integers(0, NCLS, size=(B, NE)) * valid).astype(np.int32),
            "gt_valid": valid}


@pytest.fixture(scope="module")
def models():
    """The JAX model at the golden config with droppath 0, its PRNGKey(0)
    weights, and a factory of ports with those weights (strict load)."""
    from unav_yolyolva_tpu.core.config import load_config_dict as jcfg
    from unav_yolyolva_tpu.models import build_model as jbuild
    from unav_yolyolva_tpu_torch.core import load_config_dict
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.utils.convert import params_from_jax
    from tests._torch_port_common import np_tree

    jc = jcfg(OVER)
    jmodel = jbuild(jc)
    dummy = {"visual": jnp.zeros((B, T, 64)), "audio": jnp.zeros((B, T, 16)),
             "mask": jnp.ones((B, T), bool), "m_scores": jnp.zeros((B, T)),
             "m_start_end": jnp.zeros((B, T)), "m_labels": jnp.zeros((B, T, NCLS))}
    params = np_tree(jax.jit(lambda k, d: jmodel.init(
        {"params": k, "droppath": k}, d, train=False))(jax.random.PRNGKey(0), dummy))
    cfg = load_config_dict(OVER)
    sd = params_from_jax(params)

    def port():
        m = build_model(cfg, device="cpu", seed=None)
        m.load_state_dict(sd, strict=True)
        return m

    return jmodel, params, jc, port, cfg


def _jax_targets(jc, batch):
    from unav_yolyolva_tpu.geometry.points import concat_points, generate_points
    from unav_yolyolva_tpu.train.step import build_targets

    m = jc["model"]
    pts = jnp.asarray(concat_points(generate_points(T, m["regression_range"], 2)))
    return build_targets({k: jnp.asarray(v) for k, v in batch.items()}, pts, T, NCLS, True)


def _grad_map(tree):
    """Per torch key, a JAX param-tree grad in the port's layout (no droppath
    scales: droppath is 0 in both packages)."""
    from unav_yolyolva_tpu_torch.utils.convert import build_key_map, state_dict_from_entries

    return state_dict_from_entries(build_key_map((2, 3, 5), with_droppath=False),
                                   jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("kw,no_pos", [({}, False), ({"loss_weight": -1.0}, False),
                                       ({"label_smoothing": 0.1}, False), ({}, True)])
def test_compute_losses(models, kw, no_pos):
    from unav_yolyolva_tpu.models.meta_arch import compute_losses as jcompute
    from unav_yolyolva_tpu_torch.models.meta_arch import compute_losses

    _, _, jc, port_fn, _ = models
    batch = _train_batch(70)
    ms, mse, ml, gcls, greg = _jax_targets(jc, batch)
    if no_pos:
        gcls = jnp.zeros_like(gcls)
    inputs = {"visual": batch["visual"], "audio": batch["audio"], "mask": batch["mask"],
              "m_scores": ms, "m_start_end": mse, "m_labels": ml}
    with torch.no_grad():    # the same forward outputs go into both assemblies
        tout = port_fn()({k: t(np.asarray(v)) for k, v in inputs.items()})
    out = jax.tree.map(lambda a: jnp.asarray(a.numpy()), tout)
    ref, ref_norm = jcompute(out, gcls, greg, jnp.asarray(250.0), **kw)
    got, norm = compute_losses(tout, t(np.asarray(gcls)), t(np.asarray(greg)),
                               torch.tensor(250.0), **kw)
    assert set(got) == set(ref)
    for k in ref:
        close(got[k], ref[k], rtol=2e-4, atol=1e-6)
    close(norm, ref_norm, rtol=1e-6)
    assert (float(got["reg_loss"]) == 0.0) == no_pos


def test_train_step_gradients(models):
    """One step's grads of every parameter against jax.grad of the JAX
    loss: norm-wise <= 1e-4 per tensor, and elementwise rtol 1e-3 with an
    atol of 1e-4 x the tensor's largest grad (elements near zero carry the
    other summation order's absolute error). A grad whose norm is below
    1e-6 x the largest tensor's is exactly zero in exact arithmetic."""
    from unav_yolyolva_tpu.models.meta_arch import compute_losses as jcompute
    from unav_yolyolva_tpu.train.step import _loss_kwargs
    from unav_yolyolva_tpu_torch.geometry.points import concat_points, generate_points
    from unav_yolyolva_tpu_torch.models.meta_arch import compute_losses
    from unav_yolyolva_tpu_torch.train.step import build_targets, loss_kwargs

    jmodel, params, jc, port_fn, cfg = models
    batch = _train_batch(71)
    ms, mse, ml, gcls, greg = _jax_targets(jc, batch)
    inputs = {"visual": batch["visual"], "audio": batch["audio"], "mask": batch["mask"],
              "m_scores": ms, "m_start_end": mse, "m_labels": ml}

    def loss_fn(p):
        out = jmodel.apply(p, inputs, train=True, rngs={"droppath": jax.random.PRNGKey(1)})
        return jcompute(out, gcls, greg, jnp.asarray(250.0), **_loss_kwargs(jc))[0]["final_loss"]

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    ref_grads = _grad_map(ref_grads["params"])

    port = port_fn().train()
    tb = {k: t(v) for k, v in batch.items()}
    pts = t(concat_points(generate_points(T, cfg["model"]["regression_range"], 2)))
    tms, tmse, tml, tcls, treg = build_targets(tb, pts, T, NCLS, True)
    out = port({"visual": tb["visual"], "audio": tb["audio"], "mask": tb["mask"],
                "m_scores": tms, "m_start_end": tmse, "m_labels": tml})
    loss = compute_losses(out, tcls, treg, torch.tensor(250.0), **loss_kwargs(cfg))[0]
    loss["final_loss"].backward()
    close(loss["final_loss"], ref_loss, rtol=2e-4)
    no_grad = set()
    zero = 1e-6 * max(np.linalg.norm(g.numpy()) for g in ref_grads.values())
    for name, p in port.named_parameters():
        ref = ref_grads[name].numpy()
        if p.grad is None:
            no_grad.add(name)
            assert not ref.any(), name
            continue
        g = p.grad.numpy()
        if np.linalg.norm(ref) < zero:
            # a bias of k (or of its LayerNorm) shifts every logit of a row
            # alike; softmax cancels it, so the exact grad is 0 and both
            # packages hold rounding noise only
            assert np.linalg.norm(g) < zero, name
            continue
        err = np.linalg.norm(g - ref) / np.linalg.norm(ref)
        assert err <= 1e-4, (name, err)
        np.testing.assert_allclose(g, ref, rtol=1e-3, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)
    # only the Alignment's argmax-only class heads get no grad (zero in JAX)
    assert no_grad <= {"alignment.fc_video_cls.weight", "alignment.fc_video_cls.bias",
                       "alignment.fc_text_cls.weight", "alignment.fc_text_cls.bias"}


def _port_train(port_fn, cfg, batches):
    from unav_yolyolva_tpu_torch.train import (create_train_state, make_optimizer,
                                               make_train_step)

    model = port_fn()
    opt, _ = make_optimizer(model, cfg["opt"], ITERS, cfg["train_cfg"]["clip_grad_l2norm"])
    state = create_train_state(model, opt, cfg["train_cfg"]["init_loss_norm"])
    step = make_train_step(model, opt, cfg, device="cpu")
    return state, step, [step(state, b) for b in batches]


def test_three_step_trajectory_matches_jax(models):
    """Losses per step (rtol 1e-3: each step starts from weights that differ
    by the previous steps' rounding) and the params and EMA after step 3.
    Adam divides each update by its grad's running RMS, so a grad near zero
    whose sign flips between the packages moves that weight by +-lr instead
    of -+lr: params get an atol of 4 x lr over the two moving steps, and
    99% of the elements must agree to 1e-2 x lr."""
    from unav_yolyolva_tpu.train import create_train_state as jstate
    from unav_yolyolva_tpu.train import make_optimizer as jopt
    from unav_yolyolva_tpu.train import make_train_step as jstep

    jmodel, params, jc, port_fn, cfg = models
    batches = [_train_batch(80 + i) for i in range(3)]
    tx, _ = jopt(params, jc["opt"], ITERS, jc["train_cfg"]["clip_grad_l2norm"])
    js = jstate(jax.tree.map(jnp.asarray, params), tx, jc["train_cfg"]["init_loss_norm"])
    step = jstep(jmodel, tx, jc)
    ref_losses = []
    for b in batches:
        js, losses = step(js, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))
        ref_losses.append(jax.tree.map(np.asarray, losses))

    state, _, losses = _port_train(port_fn, cfg, batches)
    for got, ref in zip(losses, ref_losses):
        for k in ("final_loss", "cls_loss", "reg_loss", "intra_contr_loss"):
            close(got[k], ref[k], rtol=1e-3, atol=1e-6)
        assert int(got["num_pos"]) == int(ref["num_pos"])
    close(state.loss_normalizer, js.loss_normalizer, rtol=1e-6)
    assert state.step == 3 and state.optimizer.count == 3

    p0 = _grad_map(params["params"])
    for which, tree in (("params", js.params), ("ema", js.ema_params)):
        ref = _grad_map(tree["params"])
        mod = state.model if which == "params" else state.ema
        moved = 0
        for name, p in mod.named_parameters():
            got, want = _np(p), ref[name].numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=4 * LR, err_msg=name)
            close_frac = np.mean(np.abs(got - want) <= 1e-2 * LR)
            assert close_frac >= 0.99, (which, name, close_frac)
            moved += int((np.abs(want - p0[name].numpy()) > 0).sum())
        assert moved > 0


def test_checkpoint_round_trip_resumes(models, tmp_path):
    """Save after step 1; a fresh state loaded from it takes step 2 exactly
    as the state that kept going does."""
    from unav_yolyolva_tpu_torch.train import (create_train_state, find_latest_checkpoint,
                                               load_checkpoint, make_optimizer,
                                               make_train_step, save_checkpoint)

    _, _, _, port_fn, cfg = models
    b1, b2 = _train_batch(90), _train_batch(91)
    state, step, _ = _port_train(port_fn, cfg, [b1])
    save_checkpoint(state, 0, str(tmp_path))
    save_checkpoint(state, 0, str(tmp_path))                 # over an existing one
    going = step(state, b2)

    model = port_fn()
    opt, _ = make_optimizer(model, cfg["opt"], ITERS)
    fresh = create_train_state(model, opt, 1.0)
    ckpt = find_latest_checkpoint(str(tmp_path))
    assert ckpt.endswith("checkpoint")
    assert load_checkpoint(ckpt, fresh)["epoch"] == 0 and fresh.step == 1
    resumed = make_train_step(model, opt, cfg, device="cpu")(fresh, b2)
    for k in going:
        assert torch.equal(going[k], resumed[k]), k
    for a, b_ in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(a, b_)
    for a, b_ in zip(state.ema.parameters(), fresh.ema.parameters()):
        assert torch.equal(a, b_)
    assert torch.equal(state.loss_normalizer, fresh.loss_normalizer)

    # a crash between the two renames leaves only <name>.old: it is recovered
    import os

    os.rename(ckpt, ckpt + ".old")
    assert find_latest_checkpoint(str(tmp_path)) == ckpt and os.path.isdir(ckpt)
    best = save_checkpoint(state, 1, str(tmp_path), is_best=True)
    assert "optimizer" not in torch.load(os.path.join(best, "state.pt"))
