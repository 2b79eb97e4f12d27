"""PyTorch port vs the JAX package: the train step at the bf16 compute policy
(`tpu.compute_dtype: bfloat16`), on the CPU.

The JAX side runs with FUSED_MHCA "always" and UNAV_FUSED_CSP "always" (its
Pallas kernels in interpret mode, as the port runs its kernels' plain
versions), compiled with XLA's `xla_allow_excess_precision` off
(tests/test_torch_port_bf16.py). At this test's width (embd 32) the JAX CSP
layer takes its module path (the fused layer wants mid % 128 == 0), whose
three MHCAs run the hand-written bf16 backward kernel; the port's CSP layer
is always the fused one (tests/test_torch_port_bf16_train.py holds the two
CSP backwards against each other).

- One step's grads of every parameter against jax.grad of the JAX bf16 loss
  (droppath 0): norm-wise at most 1/4 of JAX's bf16-vs-fp32 gap (the fp32
  grads are the port's, which equal JAX's fp32 ones to 1e-4:
  tests/test_torch_port_train.py), or, where one bf16 rounding that the two
  programs' fp32 sums put on other sides of a bf16 value spreads through
  every later op, at most 2x JAX's own move under a one-ulp change of one
  input value. A grad whose fp32 norm is below 1e-6 x the largest tensor's
  is exactly zero in exact arithmetic: there both packages' bf16 rounding
  noise is held below 1e-4 x the largest (100x the fp32 test's bound).
- A 3-step trajectory of make_train_step against the JAX make_train_step
  (AdamW, flat_adamw), parameters, AdamW state, EMA and losses in fp32 in
  both: losses, params and EMA at tolerances stated at each comparison."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from tests._torch_port_common import close, lengths_mask, np_tree, t
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)

EXACT = {"xla_allow_excess_precision": False}
B, T, NCLS, NE, LR, ITERS = 2, 32, 4, 4, 1e-3, 2
ARCH = (2, 2, 2)
MODEL = {"raw_input_dim_V": 24, "raw_input_dim_A": 16, "input_dim_V": 32, "input_dim_A": 32,
         "embd_dim": 32, "head_dim": 32, "use_abs_pe": True, "class_aware": True,
         "backbone_arch": list(ARCH), "regression_range": [[0, 4], [4, 8], [8, 10000]]}


def _over(dtype: str):
    return {"dataset": {"num_classes": NCLS, "max_seq_len": T, "max_num_events": NE},
            "model": MODEL,
            "opt": {"learning_rate": LR, "weight_decay": 1e-4, "epochs": 2, "warmup_epochs": 1},
            "train_cfg": {"loss_weight": 1, "droppath": 0.0}, "tpu": {"compute_dtype": dtype}}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _train_batch(seed):
    rng = np.random.default_rng(seed)
    mask = lengths_mask(B, T, [T, 20])
    m = mask[..., None].astype(np.float32)
    starts = rng.uniform(0, 18, size=(B, NE)).astype(np.float32)
    segs = np.stack([starts, starts + rng.uniform(2, 12, size=(B, NE))], -1)
    valid = np.arange(NE)[None, :] < np.array([[3], [2]])
    return {"visual": (rng.normal(size=(B, T, 24)) * m).astype(np.float32),
            "audio": (rng.normal(size=(B, T, 16)) * m).astype(np.float32),
            "mask": mask,
            "gt_segments": (segs * valid[..., None]).astype(np.float32),
            "gt_labels": (rng.integers(0, NCLS, size=(B, NE)) * valid).astype(np.int32),
            "gt_valid": valid}


@pytest.fixture(scope="module")
def models():
    """The JAX model at bf16 (FUSED_MHCA / UNAV_FUSED_CSP "always") with
    PRNGKey(0) weights, and a factory of ports with those weights at either
    dtype (strict load)."""
    import unav_yolyolva_tpu.models.blocks as jblocks
    from unav_yolyolva_tpu.core.config import load_config_dict as jcfg
    from unav_yolyolva_tpu.models import build_model as jbuild
    from unav_yolyolva_tpu_torch.core import load_config_dict
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.utils.convert import params_from_jax

    prev, prev_env = jblocks.FUSED_MHCA, os.environ.get("UNAV_FUSED_CSP")
    jblocks.FUSED_MHCA = "always"
    os.environ["UNAV_FUSED_CSP"] = "always"
    jc = jcfg(_over("bfloat16"))
    jmodel = jbuild(jc)
    dummy = {"visual": jnp.zeros((B, T, 24)), "audio": jnp.zeros((B, T, 16)),
             "mask": jnp.ones((B, T), bool), "m_scores": jnp.zeros((B, T)),
             "m_start_end": jnp.zeros((B, T)), "m_labels": jnp.zeros((B, T, NCLS))}
    params = np_tree(jax.jit(lambda k, d: jmodel.init(
        {"params": k, "droppath": k}, d, train=False))(jax.random.PRNGKey(0), dummy))
    sd = params_from_jax(params)

    def port(dtype="bfloat16"):
        m = build_model(load_config_dict(_over(dtype)), device="cpu", seed=None)
        m.load_state_dict(sd, strict=True)
        return m

    yield jmodel, params, jc, port
    jblocks.FUSED_MHCA = prev
    if prev_env is None:
        os.environ.pop("UNAV_FUSED_CSP", None)
    else:
        os.environ["UNAV_FUSED_CSP"] = prev_env


def _grad_map(tree):
    from unav_yolyolva_tpu_torch.utils.convert import build_key_map, state_dict_from_entries

    return state_dict_from_entries(build_key_map(ARCH, with_droppath=False),
                                   jax.tree.map(np.asarray, tree))


def _port_grads(model, batch):
    from unav_yolyolva_tpu_torch.geometry.points import concat_points, generate_points
    from unav_yolyolva_tpu_torch.models.meta_arch import compute_losses
    from unav_yolyolva_tpu_torch.train.step import build_targets, loss_kwargs
    from unav_yolyolva_tpu_torch.core import load_config_dict

    cfg = load_config_dict(_over("bfloat16"))
    model.train()
    tb = {k: t(v) for k, v in batch.items()}
    pts = t(concat_points(generate_points(T, cfg["model"]["regression_range"], 2)))
    ms, mse, ml, gcls, greg = build_targets(tb, pts, T, NCLS, True)
    out = model({"visual": tb["visual"], "audio": tb["audio"], "mask": tb["mask"],
                 "m_scores": ms, "m_start_end": mse, "m_labels": ml})
    loss = compute_losses(out, gcls, greg, torch.tensor(250.0), **loss_kwargs(cfg))[0]
    loss["final_loss"].backward()
    return float(loss["final_loss"]), {n: p.grad for n, p in model.named_parameters()}


def test_bf16_train_step_gradients(models):
    from unav_yolyolva_tpu.geometry.points import concat_points, generate_points
    from unav_yolyolva_tpu.models.meta_arch import compute_losses as jcompute
    from unav_yolyolva_tpu.train.step import _loss_kwargs, build_targets

    jmodel, params, jc, port_fn = models
    batch = _train_batch(71)
    pts = jnp.asarray(concat_points(generate_points(T, jc["model"]["regression_range"], 2)))
    ms, mse, ml, gcls, greg = build_targets({k: jnp.asarray(v) for k, v in batch.items()},
                                            pts, T, NCLS, True)

    def loss_fn(p, visual):
        inputs = {"visual": visual, "audio": batch["audio"], "mask": batch["mask"],
                  "m_scores": ms, "m_start_end": mse, "m_labels": ml}
        out = jmodel.apply(p, inputs, train=True, rngs={"droppath": jax.random.PRNGKey(1)})
        return jcompute(out, gcls, greg, jnp.asarray(250.0), **_loss_kwargs(jc))[0]["final_loss"]

    vis = jnp.asarray(batch["visual"])
    run = jax.jit(jax.value_and_grad(loss_fn)).lower(params, vis).compile(EXACT)
    ref_loss, ref = run(params, vis)
    ref = _grad_map(ref["params"])
    loss, got = _port_grads(port_fn("bfloat16"), batch)
    _, got32 = _port_grads(port_fn("float32"), batch)
    # the losses: bf16 logits through fp32 loss assembly
    assert abs(loss - float(ref_loss)) <= 1e-3 * abs(float(ref_loss)), (loss, float(ref_loss))

    # JAX's own move under one input value moved by one bf16 ulp (two draws)
    rng = np.random.default_rng(72)
    moves = []
    for _ in range(2):
        v = batch["visual"].copy()
        i, j, k = 0, int(rng.integers(0, T)), int(rng.integers(0, v.shape[-1]))
        up = torch.tensor([v[i, j, k]]).bfloat16().view(torch.int16) + (1 if v[i, j, k] >= 0
                                                                          else -1)
        v[i, j, k] = up.view(torch.bfloat16).float().item()
        moves.append(_grad_map(run(params, jnp.asarray(v))[1]["params"]))

    zero = 1e-6 * max(np.linalg.norm(g.numpy()) for g in ref.values())
    strict = fallback = 0
    for name, g in got.items():
        r = ref[name].numpy()
        if g is None:
            assert not r.any(), name                  # argmax-only class heads
            continue
        g, g32 = g.numpy(), got32[name].numpy()
        if np.linalg.norm(g32) < zero:
            # a bias of k (or of its LayerNorm) shifts every logit of a row
            # alike; softmax cancels it, so the exact grad is 0 and both
            # packages hold rounding noise: bf16's, 100x fp32's bound
            assert np.linalg.norm(g) < 100 * zero and np.linalg.norm(r) < 100 * zero, name
            continue
        gap, ref_gap = _rel(g, r), _rel(r, g32)
        if gap <= 0.25 * ref_gap:
            strict += 1
            continue
        move = float(np.mean([_rel(m[name].numpy(), r) for m in moves]))
        assert gap <= 2 * move, (f"{name}: port vs JAX bf16 {gap:.3e}, JAX bf16 vs fp32 "
                                 f"{ref_gap:.3e}, JAX's one-ulp move {move:.3e}")
        fallback += 1
    assert strict >= 3 * fallback, (strict, fallback)


def test_bf16_three_step_trajectory_matches_jax(models):
    """Losses per step within 2e-3 relative (bf16 logits; each step starts
    from weights the earlier steps' bf16 rounding moved), the loss
    normalizer; params and EMA after step 3 within 4 x lr (Adam moves a
    weight by at most ~lr a step whatever its grad's rounding: the biases
    of k and of its LayerNorm, whose exact grad is 0 under the softmax's
    shift invariance, move by rounding noise of either sign), and 95% of all
    their elements within 0.1 x lr (bf16 grads a few percent apart, as the
    gradient test finds, move Adam's update by about that much)."""
    from unav_yolyolva_tpu.train import create_train_state as jstate
    from unav_yolyolva_tpu.train import make_optimizer as jopt
    from unav_yolyolva_tpu.train import make_train_step as jstep
    from unav_yolyolva_tpu_torch.core import load_config_dict
    from unav_yolyolva_tpu_torch.train import (create_train_state, make_optimizer,
                                               make_train_step)

    jmodel, params, jc, port_fn = models
    batches = [_train_batch(80 + i) for i in range(3)]
    tx, _ = jopt(params, jc["opt"], ITERS, jc["train_cfg"]["clip_grad_l2norm"])
    js = jstate(jax.tree.map(jnp.asarray, params), tx, jc["train_cfg"]["init_loss_norm"])
    dev = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    step = jstep(jmodel, tx, jc).lower(js, dev[0], jax.random.PRNGKey(0)).compile(EXACT)
    ref_losses = []
    for b in dev:
        js, losses = step(js, b, jax.random.PRNGKey(0))
        ref_losses.append(jax.tree.map(np.asarray, losses))

    cfg = load_config_dict(_over("bfloat16"))
    model = port_fn("bfloat16")
    opt, _ = make_optimizer(model, cfg["opt"], ITERS, cfg["train_cfg"]["clip_grad_l2norm"])
    state = create_train_state(model, opt, cfg["train_cfg"]["init_loss_norm"])
    port_step = make_train_step(model, opt, cfg, device="cpu")
    losses = [port_step(state, b) for b in batches]
    for got, ref in zip(losses, ref_losses):
        for k in ("final_loss", "cls_loss", "reg_loss", "intra_contr_loss"):
            close(got[k], ref[k], rtol=2e-3, atol=1e-6)
        assert got["final_loss"].dtype == torch.float32
        assert int(got["num_pos"]) == int(ref["num_pos"])
    close(state.loss_normalizer, js.loss_normalizer, rtol=1e-5)
    assert state.step == 3 and state.optimizer.count == 3
    assert all(p.dtype == torch.float32 for p in state.model.parameters())
    assert all(p.dtype == torch.float32 for p in state.ema.parameters())

    p0 = _grad_map(params["params"])
    for which, tree in (("params", js.params), ("ema", js.ema_params)):
        ref = _grad_map(tree["params"])
        mod = state.model if which == "params" else state.ema
        moved = near = total = 0
        for name, p in mod.named_parameters():
            got, want = p.detach().numpy(), ref[name].numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=4 * LR, err_msg=name)
            near += int((np.abs(got - want) <= 0.1 * LR).sum())
            total += got.size
            moved += int((np.abs(want - p0[name].numpy()) > 0).sum())
        assert near >= 0.95 * total, (which, near / total)
        assert moved > 0
