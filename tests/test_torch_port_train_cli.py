"""PyTorch port vs the JAX package: the training entry point from files, on
the CPU.

  * utils/msgpack.py reads what the JAX save_checkpoint writes (params, EMA
    and the optimizer state in the flat_adamw, optax-chain AdamW and SGD
    layouts) bit for bit as flax.serialization.msgpack_restore does;
  * load_checkpoint on a JAX folder: params, EMA and the moments after the
    layout transforms exact, step / count / loss normalizer equal; then two
    steps in both packages agree at the 3-step trajectory's tolerances
    (tests/test_torch_port_train.py): losses rtol 1e-3, params atol 4 x lr
    with 99% of the elements within 1e-2 x lr;
  * the schedules without warmup equal optax's at every step;
  * valid_one_epoch with the validation losses, EMA and raw weights:
    epoch-averaged losses rtol 1e-4, mAP within 1e-6;
  * the train CLI against the root train.py: both resume from one JAX
    checkpoint and train 2 epochs (droppath 0): the same checkpoint
    folders, per-epoch losses rtol 1e-3, model_best's best_mAP within 1e-3,
    and the final pass on model_best's raw weights."""

import argparse
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import yaml
from flax import serialization

from unav_yolyolva_tpu_torch.utils import msgpack
from tests._torch_port_common import close, lengths_mask, np_tree
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)

NCLS, T, NE, LR, ITERS = 5, 64, 8, 1e-3, 2
# a pyramid of three levels (2 CSP layers each way): the JAX train step's
# compile in Pallas interpret mode grows with the layer count
MODEL = {"raw_input_dim_V": 64, "raw_input_dim_A": 16, "input_dim_V": 32,
         "input_dim_A": 32, "embd_dim": 32, "head_dim": 32, "use_abs_pe": True,
         "class_aware": True, "backbone_arch": [2, 2, 2],
         "regression_range": [[0, 4], [4, 8], [8, 10000]]}
OPT = {"learning_rate": LR, "weight_decay": 1e-4, "epochs": 2, "warmup_epochs": 1}
LAYOUTS = {"flat_adamw": ({"type": "AdamW"}, "1"), "chain_adamw": ({"type": "AdamW"}, "0"),
           "sgd": ({"type": "SGD", "momentum": 0.9}, "0")}


def same_tree(a, b, path=""):
    """Two restored msgpack trees: the same structure, types and bits."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert a == b, (path, a, b)


def _train_batch(seed, b=2):
    rng = np.random.default_rng(seed)
    mask = lengths_mask(b, T, [T, 45, 30, 60][:b])
    m = mask[..., None].astype(np.float32)
    starts = rng.uniform(0, 40, size=(b, NE)).astype(np.float32)
    segs = np.stack([starts, starts + rng.uniform(2, 24, size=(b, NE))], -1)
    valid = np.arange(NE)[None, :] < np.array([[3], [2], [1], [2]])[:b]
    return {"visual": (rng.normal(size=(b, T, 64)) * m).astype(np.float32),
            "audio": (rng.normal(size=(b, T, 16)) * m).astype(np.float32),
            "mask": mask,
            "gt_segments": (segs * valid[..., None]).astype(np.float32),
            "gt_labels": (rng.integers(0, NCLS, size=(b, NE)) * valid).astype(np.int32),
            "gt_valid": valid}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Synthetic files (8 train and 8 validation videos), the config over
    them (droppath 0, one JAX device), and the JAX model with PRNGKey(0)
    weights."""
    from unav_yolyolva_tpu.core.config import load_config_dict as jcfg
    from unav_yolyolva_tpu.models import build_model as jbuild
    from unav_yolyolva_tpu_torch.data.synthetic import make_synthetic_dataset

    root = str(tmp_path_factory.mktemp("train_cli"))
    synth = make_synthetic_dataset(root, num_videos=16, num_classes=NCLS, min_len=40,
                                   max_len=T, visual_dim=64, audio_dim=16, seed=11,
                                   events_per_video=2)
    cfg_dict = {
        "init_rand_seed": 7,
        "train_split": ["train"], "val_split": ["validation"], "test_split": ["validation"],
        "dataset": {"json_file": synth["json_file"], "feat_folder": synth["feat_folder"],
                    "num_classes": NCLS, "max_seq_len": T, "max_num_events": NE},
        "loader": {"batch_size": 4, "num_workers": 1},
        "model": MODEL,
        "opt": OPT,
        "train_cfg": {"loss_weight": 1, "droppath": 0.0, "eval_freq": 1},
        "test_cfg": {"pre_nms_topk": 100, "max_seg_num": 20, "min_score": 0.001,
                     "nms_sigma": 0.4, "iou_threshold": 0.7},
        "tpu": {"num_devices": 1},
    }
    jc = jcfg(cfg_dict)
    jmodel = jbuild(jc)
    dummy = {"visual": jnp.zeros((2, T, 64)), "audio": jnp.zeros((2, T, 16)),
             "mask": jnp.ones((2, T), bool), "m_scores": jnp.zeros((2, T)),
             "m_start_end": jnp.zeros((2, T)), "m_labels": jnp.zeros((2, T, NCLS))}
    params = np_tree(jax.jit(lambda k, d: jmodel.init(
        {"params": k, "droppath": k}, d, train=False))(jax.random.PRNGKey(0), dummy))
    return {"root": root, "synth": synth, "cfg_dict": cfg_dict, "jc": jc, "jmodel": jmodel,
            "params": params}


def _port_cfg(cfg_dict, **opt):
    from unav_yolyolva_tpu_torch.core import load_config_dict

    return load_config_dict(dict(cfg_dict, opt=dict(cfg_dict["opt"], **opt)))


@pytest.fixture(scope="module")
def jax_runs(data, tmp_path_factory):
    """Per layout: the JAX state after one step written by the JAX
    save_checkpoint (epoch 0), then two more JAX steps' losses and params."""
    from unav_yolyolva_tpu.core.config import load_config_dict as jcfg
    from unav_yolyolva_tpu.train import create_train_state, make_optimizer, make_train_step
    from unav_yolyolva_tpu.train.checkpoint import save_checkpoint

    runs = {}
    batches = [_train_batch(80 + i) for i in range(3)]
    for name, (opt, fused) in LAYOUTS.items():
        jc = jcfg(dict(data["cfg_dict"], opt=dict(OPT, **opt)))
        old = os.environ.get("UNAV_FUSED_OPT")
        os.environ["UNAV_FUSED_OPT"] = fused
        try:
            tx, _ = make_optimizer(data["params"], jc["opt"], ITERS,
                                   jc["train_cfg"]["clip_grad_l2norm"])
        finally:
            if old is None:
                del os.environ["UNAV_FUSED_OPT"]
            else:
                os.environ["UNAV_FUSED_OPT"] = old
        state = create_train_state(jax.tree.map(jnp.asarray, data["params"]), tx, 250.0)
        step = make_train_step(data["jmodel"], tx, jc)
        dev = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
        state, _ = step(state, dev[0], jax.random.PRNGKey(0))
        folder = str(tmp_path_factory.mktemp(name))
        save_checkpoint(state, 0, folder, file_name="epoch_000", extra_meta={"best_mAP": 0.25})
        losses = []
        for b in dev[1:]:
            state, out = step(state, b, jax.random.PRNGKey(0))
            losses.append(jax.tree.map(np.asarray, out))
        runs[name] = {"dir": os.path.join(folder, "epoch_000"), "opt": opt, "losses": losses,
                      "params": np_tree(state.params), "ema": np_tree(state.ema_params),
                      "normalizer": float(state.loss_normalizer), "batches": batches}
    return runs


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_msgpack_reader_is_flax_msgpack_restore(jax_runs, layout):
    files = sorted(os.listdir(jax_runs[layout]["dir"]))
    assert files == ["ema.msgpack", "meta.json", "opt_state.msgpack", "params.msgpack"]
    for f in files[:1] + files[2:]:
        with open(os.path.join(jax_runs[layout]["dir"], f), "rb") as fh:
            raw = fh.read()
        same_tree(msgpack.restore(raw), serialization.msgpack_restore(raw), f)


def _expected_moments(layout, ckpt_dir):
    """The moments in the port's key space, through flax's own restore and
    jax.flatten_util's unravel (independent of the port's reader and its
    ravel order)."""
    from jax.flatten_util import ravel_pytree

    from unav_yolyolva_tpu_torch.utils.convert import jax_key_map, state_dict_from_entries

    def read(f):
        with open(os.path.join(ckpt_dir, f), "rb") as fh:
            return serialization.msgpack_restore(fh.read())

    params, opt = read("params.msgpack"), read("opt_state.msgpack")
    entries = jax_key_map(params)
    sd = lambda tree: state_dict_from_entries(entries, tree["params"])  # noqa: E731
    if layout == "flat_adamw":
        _, unravel = ravel_pytree(params)
        return {"exp_avg": sd(np_tree(unravel(opt["mu"]))),
                "exp_avg_sq": sd(np_tree(unravel(opt["nu"])))}, int(opt["count"])
    if layout == "chain_adamw":
        adam = opt["1"]["0"]
        return {"exp_avg": sd(adam["mu"]), "exp_avg_sq": sd(adam["nu"])}, int(adam["count"])
    return ({"momentum_buffer": sd(opt["1"]["1"]["0"]["trace"])},
            int(opt["1"]["1"]["1"]["count"]))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_jax_checkpoint_resumes_in_the_port(data, jax_runs, layout):
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.train import (create_train_state, load_checkpoint,
                                               make_optimizer, make_train_step)
    from unav_yolyolva_tpu_torch.utils.convert import params_from_jax

    run = jax_runs[layout]
    cfg = _port_cfg(data["cfg_dict"], **run["opt"])
    model = build_model(cfg, device="cpu", seed=3)
    opt, _ = make_optimizer(model, cfg["opt"], ITERS, cfg["train_cfg"]["clip_grad_l2norm"])
    state = create_train_state(model, opt, cfg["train_cfg"]["init_loss_norm"])
    restored = load_checkpoint(run["dir"], state)
    assert restored["epoch"] == 0 and restored["meta"]["best_mAP"] == 0.25

    for f, mod in (("params.msgpack", state.model), ("ema.msgpack", state.ema)):
        with open(os.path.join(run["dir"], f), "rb") as fh:
            want = params_from_jax(serialization.msgpack_restore(fh.read()))
        for name, p in mod.named_parameters():
            assert torch.equal(p.detach(), want[name]), (f, name)
    moments, count = _expected_moments(layout, run["dir"])
    assert count == 1 and opt.count == 1 and state.step == 1
    for name, p in model.named_parameters():
        st = opt.inner.state[p]
        for k, v in moments.items():
            assert torch.equal(st[k], v[name]), (k, name)
        if "step" in st:
            assert float(st["step"]) == count
    with open(os.path.join(run["dir"], "meta.json")) as fh:
        assert float(state.loss_normalizer) == json.load(fh)["loss_normalizer"]

    step = make_train_step(model, opt, cfg, device="cpu")
    losses = [step(state, b) for b in run["batches"][1:]]
    for got, ref in zip(losses, run["losses"]):
        for k in ("final_loss", "cls_loss", "reg_loss", "intra_contr_loss"):
            close(got[k], ref[k], rtol=1e-3, atol=1e-6)
        assert int(got["num_pos"]) == int(ref["num_pos"])
    close(state.loss_normalizer, run["normalizer"], rtol=1e-6)
    for which, mod in (("params", state.model), ("ema", state.ema)):
        ref = params_from_jax(run[which])
        for name, p in mod.named_parameters():
            got, want = p.detach().numpy(), ref[name].numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=4 * LR, err_msg=name)
            assert np.mean(np.abs(got - want) <= 1e-2 * LR) >= 0.99, (which, name)


def test_an_unknown_optimizer_layout_is_named(data):
    from unav_yolyolva_tpu_torch.utils.convert import opt_state_from_jax

    with pytest.raises(ValueError, match="no known layout.*momentum_trace"):
        opt_state_from_jax({"0": {"momentum_trace": np.zeros(3, np.float32)}},
                           data["params"])


@pytest.mark.parametrize("opt", [
    {"schedule_type": "cosine", "epochs": 3, "eta_min": 1e-8},
    {"schedule_type": "cosine", "epochs": 1, "eta_min": 0.0, "learning_rate": 0.05},
    {"schedule_type": "multistep", "epochs": 4, "schedule_steps": [1, 2, 2],
     "schedule_gamma": 0.1},
    {"schedule_type": "multistep", "epochs": 4, "schedule_steps": [3], "schedule_gamma": 0.5},
])
def test_schedules_without_warmup_are_optax(opt):
    """Every step in [0, max_steps + 2], the multistep boundaries among
    them: a boundary takes effect at its step (optax's sign rule)."""
    from unav_yolyolva_tpu.train.optim import make_schedule as jschedule
    from unav_yolyolva_tpu_torch.train import make_schedule

    cfg = dict({"learning_rate": 1e-3, "warmup": False, "warmup_epochs": 5}, **opt)
    iters = 7
    ref, got = jschedule(cfg, iters), make_schedule(cfg, iters)
    steps = range(cfg["epochs"] * iters + 3)
    want = np.array([float(ref(jnp.asarray(s, jnp.int32))) for s in steps])
    have = np.array([got(s) for s in steps])
    np.testing.assert_allclose(have, want, rtol=1e-6, atol=0)
    if opt["schedule_type"] == "multistep":
        b = iters * opt["schedule_steps"][0]
        assert have[b - 1] == np.float32(cfg["learning_rate"]) and have[b] < have[b - 1]


@pytest.mark.parametrize("use_ema", [True, False])
def test_valid_one_epoch_with_losses_is_the_jax_one(data, use_ema):
    """The same converted state (raw weights 0.9x the EMA's) validated in
    both packages. The JAX side serves the raw weights by swapping them into
    the EMA slot of one compiled eval step."""
    from unav_yolyolva_tpu.data import UnAV100Dataset as JDataset
    from unav_yolyolva_tpu.data import make_batcher as jmake_batcher
    from unav_yolyolva_tpu.eval.metrics import ANETdetection as JANET
    from unav_yolyolva_tpu.train import create_train_state as jstate
    from unav_yolyolva_tpu.train import make_eval_step as jmake_eval_step
    from unav_yolyolva_tpu.train import valid_one_epoch as jvalid
    from unav_yolyolva_tpu.train.optim import make_optimizer as jopt
    from unav_yolyolva_tpu_torch.data import UnAV100Dataset, make_batcher
    from unav_yolyolva_tpu_torch.eval import make_eval_step
    from unav_yolyolva_tpu_torch.eval.metrics import ANETdetection
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.train import (create_train_state, make_optimizer,
                                               valid_one_epoch)
    from unav_yolyolva_tpu_torch.utils.convert import params_from_jax

    jc, ema = data["jc"], data["params"]
    raw = jax.tree.map(lambda p: p * np.float32(0.9), ema)
    tx, _ = jopt(ema, jc["opt"], 1)
    js = jstate(jax.tree.map(jnp.asarray, raw), tx, 137.0)
    js = js.replace(ema_params=jax.tree.map(jnp.asarray, raw if not use_ema else ema))
    ds = JDataset(False, ("validation",), **jc["dataset"])
    thr = ds.get_attributes()["tiou_thresholds"]
    ref_map, ref_losses = jvalid(js, jmake_batcher(ds, jc, False),
                                 jmake_eval_step(data["jmodel"], jc, use_ema=True), 0,
                                 evaluator=JANET(ds.json_file, "validation",
                                                 tiou_thresholds=thr, num_workers=1))

    cfg = _port_cfg(data["cfg_dict"])
    model = build_model(cfg, device="cpu", seed=None)
    model.load_state_dict(params_from_jax(raw), strict=True)
    opt, _ = make_optimizer(model, cfg["opt"], 1)
    state = create_train_state(model, opt, 137.0)
    state.ema.load_state_dict(params_from_jax(ema), strict=True)
    step = make_eval_step(state, cfg, device="cpu", with_losses=True, use_ema=use_ema)
    assert step.model is (state.ema if use_ema else state.model)
    pds = UnAV100Dataset(False, ("validation",), **cfg["dataset"])
    with make_batcher(pds, cfg, False, device="cpu") as batcher:
        got_map, losses = valid_one_epoch(state, batcher, step, 0,
                                          evaluator=ANETdetection(pds.json_file, "validation",
                                                                  tiou_thresholds=thr))
    assert set(losses) == set(ref_losses) and "final_loss" in losses
    for k, v in ref_losses.items():
        assert np.isfinite(losses[k])
        np.testing.assert_allclose(losses[k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    assert abs(got_map - ref_map) <= 1e-6


def test_train_cli_matches_the_root_train_py(data, tmp_path, monkeypatch):
    """Both CLIs resume one JAX checkpoint (epoch 0, the flat_adamw layout
    the CLI's batch of 4 takes) and train epochs 1 and 2 with -c 1,
    evaluating every epoch."""
    import train as jax_cli
    import unav_yolyolva_tpu.train as jtrain
    from unav_yolyolva_tpu.train import create_train_state, make_optimizer
    from unav_yolyolva_tpu.train.checkpoint import save_checkpoint
    from unav_yolyolva_tpu_torch.train import cli, loop

    monkeypatch.setenv("WANDB_MODE", "disabled")
    jc = data["jc"]
    tx, _ = make_optimizer(data["params"], jc["opt"], ITERS, jc["train_cfg"]["clip_grad_l2norm"],
                           local_batch=4)
    state = create_train_state(jax.tree.map(jnp.asarray, data["params"]), tx, 250.0)
    resume = save_checkpoint(state, 0, str(tmp_path / "resume"), file_name="epoch_000")

    def config(name):
        path = str(tmp_path / f"{name}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(dict(data["cfg_dict"], output_folder=str(tmp_path / name)), f)
        return path

    rec = {"jax": [], "port": []}

    def recording(fn, key):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            rec[key].append((fn.__name__, out[1] if fn.__name__ == "train_one_epoch" else out,
                             getattr(a[2], "model", None), a[0]))
            return out
        return wrapped

    for fn in ("train_one_epoch", "valid_one_epoch"):
        monkeypatch.setattr(jtrain, fn, recording(getattr(jtrain, fn), "jax"))
        monkeypatch.setattr(loop, fn, recording(getattr(loop, fn), "port"))
    jax_cli.main(argparse.Namespace(config=config("jax"), print_freq=1, ckpt_freq=1,
                                    output="run", resume=resume))
    out = cli.main(cli.parse_args([config("port"), "-p", "1", "-c", "1", "--output", "run",
                                   "--resume", resume, "--device", "cpu"]))

    jdir = os.path.join(str(tmp_path / "jax"), os.path.basename(out["ckpt_folder"]))
    assert os.path.isdir(jdir), os.listdir(str(tmp_path / "jax"))
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(out["ckpt_folder"]))
    assert {"epoch_001", "epoch_002", "model_best", "config.txt"} <= set(os.listdir(jdir))
    # epoch 1 and 2: train, validate; then the final pass on model_best
    assert [r[0] for r in rec["jax"]] == [r[0] for r in rec["port"]] == [
        "train_one_epoch", "valid_one_epoch"] * 2 + ["valid_one_epoch"]
    for (name, ref, _, _), (_, got, _, _) in zip(rec["jax"], rec["port"]):
        if name == "train_one_epoch":
            ref_l, got_l = ref, got
        else:
            assert abs(got[0] - ref[0]) <= 1e-3
            ref_l, got_l = ref[1], got[1]
        assert set(got_l) == set(ref_l) and got_l
        for k in ref_l:
            np.testing.assert_allclose(got_l[k], ref_l[k], rtol=1e-3, atol=1e-6, err_msg=k)
    for h, (_, got, _, _) in zip(out["history"], rec["port"][:4:2]):
        assert h["train_losses"] == got
    metas = [json.load(open(os.path.join(d, "model_best", "meta.json")))
             for d in (jdir, out["ckpt_folder"])]
    assert abs(metas[0]["best_mAP"] - metas[1]["best_mAP"]) <= 1e-3
    assert metas[1]["best_mAP"] == out["best_mAP"] > 0
    # the evaluations during training serve the EMA; the final pass the raw weights
    served = [(r[2], r[3]) for r in rec["port"] if r[0] == "valid_one_epoch"]
    assert all(m is s.ema for m, s in served[:2]) and served[2][0] is served[2][1].model
    assert out["final_mAP"] == rec["port"][-1][1][0]
