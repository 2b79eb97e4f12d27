"""The port's eval harness against the JAX package's, on the CPU:
ANETdetection, the score fusion, valid_one_epoch, the reference-checkpoint
filter and the eval CLI (reference .pth.tar, port checkpoint folder, JAX
msgpack folder, --saveonly, --topk, an external score file) on the golden fixture
(tests/_golden_common.py, tests/golden/eval_golden.npz)."""

import json
import os
import pickle

import numpy as np
import pytest
import torch
import yaml

from tests._golden_common import NCLS, SEED, T
from unav_yolyolva_tpu.eval import metrics as jmetrics
from unav_yolyolva_tpu.eval import postprocessing as jpost
from unav_yolyolva_tpu_torch.eval import cli, metrics, postprocessing
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "eval_golden.npz")
KEYS = ("t-start", "t-end", "label", "score")


def _annotation_db(rng, n_videos=12, n_classes=6):
    """Videos with duplicate annotations (exact and within 1e-3 s), a split
    field in mixed case, and one class that never occurs."""
    db = {}
    for v in range(n_videos):
        ants = []
        for _ in range(int(rng.integers(1, 5))):
            s = float(rng.uniform(0, 50))
            e = s + float(rng.uniform(0.5, 20))
            lab = int(rng.integers(0, n_classes - 1))
            ants.append({"label": f"c{lab}", "label_id": lab,
                         "segment": [round(s, 3), round(e, 3)]})
        ants.append(dict(ants[0]))
        ants.append(dict(ants[0], segment=[ants[0]["segment"][0] + 5e-4,
                                           ants[0]["segment"][1]]))
        db[f"v{v:02d}"] = {"subset": "Validation" if v % 4 else "train",
                           "annotations": ants}
    return db


def _predictions(rng, db, n=400, n_classes=6):
    vids = sorted(db) + ["unseen_video"]
    starts = rng.uniform(0, 60, n)
    return {"video-id": [vids[i] for i in rng.integers(0, len(vids), n)],
            "t-start": starts, "t-end": starts + rng.uniform(0.1, 25, n),
            "label": rng.integers(0, n_classes + 2, n),      # two labels never seen
            "score": rng.uniform(0, 1, n)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_anet_detection_is_the_jax_one(tmp_path, seed):
    rng = np.random.default_rng(seed)
    db = _annotation_db(rng)
    ant = tmp_path / "ant.json"
    ant.write_text(json.dumps({"database": db}))
    preds = _predictions(rng, db)
    thr = np.linspace(0.1, 0.9, 9)
    ref = jmetrics.ANETdetection(str(ant), "validation", tiou_thresholds=thr, num_workers=1)
    port = metrics.ANETdetection(str(ant), "validation", tiou_thresholds=thr)
    assert port.activity_index == ref.activity_index
    assert len(port.ground_truth["video-id"]) < sum(
        len(v["annotations"]) for v in db.values() if v["subset"] == "Validation")
    got_map, got_avg = port.evaluate(preds, verbose=False)
    ref_map, ref_avg = ref.evaluate(preds, verbose=False)
    assert 0 < ref_avg < 1
    np.testing.assert_allclose(got_map, ref_map, rtol=0, atol=1e-12)
    assert abs(got_avg - ref_avg) <= 1e-12


@pytest.mark.parametrize("fmt", ["json", "pkl"])
def test_score_fusion_is_the_jax_one(tmp_path, fmt):
    rng = np.random.default_rng(4)
    db = _annotation_db(rng)
    results = _predictions(rng, db, n=300)
    scores = {v: rng.uniform(0, 1, 6).tolist() for v in sorted(db)[:-2]}   # two missing
    path = tmp_path / f"cls.{fmt}"
    if fmt == "json":
        path.write_text(json.dumps({"results": scores}))
    else:
        path.write_bytes(pickle.dumps(scores))
    ref = jpost.postprocess_results(results, str(path), num_pred=20, topk=2)
    got = postprocessing.postprocess_results(results, str(path), num_pred=20, topk=2)
    assert got["video-id"] == ref["video-id"]
    for k in KEYS:
        np.testing.assert_array_equal(got[k], ref[k])
    assert postprocessing.results_to_dict(results) == jpost.results_to_dict(results)


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """The golden dataset and config, the JAX model's PRNGKey(0) weights as a
    reference-format .pth.tar (params_to_torch_state_dict, `module.`
    prefixed), and the JAX valid_one_epoch's mAP and detections."""
    import jax
    import jax.numpy as jnp

    from unav_yolyolva_tpu.core.config import load_config_dict as jcfg
    from unav_yolyolva_tpu.data import UnAV100Dataset, make_batcher, synthetic
    from unav_yolyolva_tpu.models import build_model
    from unav_yolyolva_tpu.train import create_train_state, make_eval_step, valid_one_epoch
    from unav_yolyolva_tpu.train.optim import make_optimizer
    from unav_yolyolva_tpu.utils.torch_convert import params_to_torch_state_dict

    root = str(tmp_path_factory.mktemp("golden"))
    synth = synthetic.make_synthetic_dataset(
        root, num_videos=8, num_classes=NCLS, min_len=40, max_len=T, visual_dim=64,
        audio_dim=16, seed=SEED, events_per_video=2)
    cfg_dict = {
        "test_split": ["validation"],
        "dataset": {"json_file": synth["json_file"], "feat_folder": synth["feat_folder"],
                    "num_classes": NCLS, "max_seq_len": T, "max_num_events": 8},
        "loader": {"batch_size": 4, "num_workers": 1},
        "model": {"raw_input_dim_V": 64, "raw_input_dim_A": 16, "input_dim_V": 32,
                  "input_dim_A": 32, "embd_dim": 32, "head_dim": 32,
                  "use_abs_pe": True, "class_aware": True},
        "train_cfg": {"loss_weight": 1},
        "test_cfg": {"pre_nms_topk": 100, "max_seg_num": 20, "min_score": 0.001,
                     "nms_sigma": 0.4, "iou_threshold": 0.7},
    }
    cfg = jcfg(cfg_dict)
    model = build_model(cfg)
    dummy = {"visual": jnp.zeros((4, T, 64)), "audio": jnp.zeros((4, T, 16)),
             "mask": jnp.ones((4, T), bool), "m_scores": jnp.zeros((4, T)),
             "m_start_end": jnp.zeros((4, T)), "m_labels": jnp.zeros((4, T, NCLS))}
    params = jax.jit(lambda k, d: model.init({"params": k, "droppath": k}, d, train=False))(
        jax.random.PRNGKey(0), dummy)
    params = jax.tree.map(np.asarray, jax.device_get(params))
    tx, _ = make_optimizer(params, cfg["opt"], 1)
    state = create_train_state(params, tx, cfg["train_cfg"]["init_loss_norm"])

    ckpt = os.path.join(root, "ref", "model_best.pth.tar")
    os.makedirs(os.path.dirname(ckpt))
    sd = params_to_torch_state_dict(params)
    torch.save({"epoch": 1, "state_dict_ema": {
        "module." + k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}}, ckpt)
    cfg_yaml = os.path.join(root, "cfg.yaml")
    with open(cfg_yaml, "w") as f:
        yaml.safe_dump(cfg_dict, f)

    ds = UnAV100Dataset(False, ("validation",), **cfg["dataset"])
    eval_step = make_eval_step(model, cfg, mesh=None, use_ema=True, with_losses=False)
    ev = jmetrics.ANETdetection(synth["json_file"], "validation",
                                tiou_thresholds=np.linspace(0.1, 0.9, 9), num_workers=1)
    jax_map, _ = valid_one_epoch(state, make_batcher(ds, cfg, False), eval_step, -1,
                                 evaluator=ev)
    out = os.path.join(root, "jax_results.pkl")
    valid_one_epoch(state, make_batcher(ds, cfg, False), eval_step, -1, output_file=out)
    with open(out, "rb") as f:
        jax_results = pickle.load(f)
    return {"root": root, "cfg_yaml": cfg_yaml, "cfg_dict": cfg_dict, "ckpt": ckpt,
            "params": params, "sd": sd, "state": state, "synth": synth,
            "jax_map": float(jax_map), "jax_results": jax_results}


def assert_results_close(got, ref):
    assert list(got["video-id"]) == list(ref["video-id"]) and len(ref["video-id"]) > 0
    np.testing.assert_array_equal(got["label"], ref["label"])
    for k, atol in (("t-start", 1e-4), ("t-end", 1e-4), ("score", 1e-5)):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=atol)


def _port_model(golden, device="cpu"):
    from unav_yolyolva_tpu_torch.core import load_config
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.utils.convert import params_from_jax

    cfg = load_config(golden["cfg_yaml"])
    model = build_model(cfg, device=device, seed=None)
    model.load_state_dict(params_from_jax(golden["params"]), strict=True)
    return model, cfg


def test_state_dict_from_reference_loads_strictly(golden):
    """The JAX export (alias slots of shared instances replicated, `module.`
    added) filters to the port's state_dict, equal to params_from_jax's."""
    from unav_yolyolva_tpu_torch.utils.convert import params_from_jax, state_dict_from_reference

    sd = {"module." + k: torch.from_numpy(np.array(v)) for k, v in golden["sd"].items()}
    sd["module.backbone.cross_att_Va.weight"] = torch.zeros(3)          # a dead key
    assert any(k.startswith("module.alignment.multiway_list.1.") for k in sd)
    got = state_dict_from_reference(sd)
    ref = params_from_jax(golden["params"])
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    model, _ = _port_model(golden)
    model.load_state_dict(got, strict=True)


def test_valid_one_epoch_is_the_jax_one(golden, tmp_path):
    from unav_yolyolva_tpu_torch.data import UnAV100Dataset, make_batcher
    from unav_yolyolva_tpu_torch.eval import make_eval_step
    from unav_yolyolva_tpu_torch.train import valid_one_epoch

    model, cfg = _port_model(golden)
    ds = UnAV100Dataset(False, cfg["test_split"], **cfg["dataset"])
    step = make_eval_step(model, cfg, device="cpu")
    ev = metrics.ANETdetection(ds.json_file, "validation",
                               tiou_thresholds=ds.get_attributes()["tiou_thresholds"])
    got_map, losses = valid_one_epoch(model, make_batcher(ds, cfg, False, device="cpu"), step,
                                      -1, evaluator=ev)
    assert losses == {}
    assert abs(got_map - golden["jax_map"]) <= 1e-6
    assert abs(got_map - float(np.load(GOLDEN)["avg_map"])) <= 1e-6
    out = str(tmp_path / "port.pkl")
    valid_one_epoch(model, make_batcher(ds, cfg, False, device="cpu"), step, -1,
                    output_file=out)
    with open(out, "rb") as f:
        assert_results_close(pickle.load(f), golden["jax_results"])
    other, _ = _port_model(golden)
    with pytest.raises(ValueError, match="does not serve"):
        valid_one_epoch(other, [], step, -1, output_file=out)


def _cli(golden, ckpt, *extra, cfg_yaml=None):
    return cli.main(cli.parse_args([cfg_yaml or golden["cfg_yaml"], ckpt, "--device", "cpu",
                                    *extra]))


def test_cli_reference_checkpoint_gives_the_golden_map(golden):
    got = _cli(golden, golden["ckpt"])
    assert abs(got - float(np.load(GOLDEN)["avg_map"])) <= 1e-6


def test_cli_port_checkpoint_folder_serves_its_ema(golden, tmp_path):
    """The folder's latest checkpoint; its EMA weights are the golden ones,
    its model weights are not."""
    from unav_yolyolva_tpu_torch.train import (create_train_state, make_optimizer,
                                               save_checkpoint)

    model, cfg = _port_model(golden)
    opt, _ = make_optimizer(model, cfg["opt"], 1)
    state = create_train_state(model, opt, cfg["train_cfg"]["init_loss_norm"])
    with torch.no_grad():
        for p in state.model.parameters():
            p.mul_(0.5)
    folder = str(tmp_path / "ckpt")
    save_checkpoint(state, 0, folder, file_name="epoch_000")
    save_checkpoint(state, 1, folder, file_name="epoch_001")
    got = _cli(golden, folder)
    assert abs(got - float(np.load(GOLDEN)["avg_map"])) <= 1e-6
    assert abs(_cli(golden, os.path.join(folder, "epoch_001")) - got) <= 1e-12


def test_cli_saveonly_is_the_jax_clis_pickle(golden):
    import argparse

    import eval as jax_cli

    out = os.path.join(os.path.dirname(golden["ckpt"]), "eval_results.pkl")
    assert jax_cli.main(argparse.Namespace(config=golden["cfg_yaml"], ckpt=golden["ckpt"],
                                           topk=-1, saveonly=True, print_freq=10)) == 0.0
    with open(out, "rb") as f:
        ref = pickle.load(f)
    os.remove(out)
    assert _cli(golden, golden["ckpt"], "--saveonly") == 0.0
    with open(out, "rb") as f:
        got = pickle.load(f)
    assert_results_close(got, ref)
    assert_results_close(got, golden["jax_results"])


def test_cli_topk_caps_the_detections(golden):
    out = os.path.join(os.path.dirname(golden["ckpt"]), "eval_results.pkl")
    _cli(golden, golden["ckpt"], "--saveonly", "--topk", "1")
    with open(out, "rb") as f:
        ids = list(pickle.load(f)["video-id"])
    assert len(ids) == len(set(ids)) > 0
    _cli(golden, golden["ckpt"], "--saveonly", "--topk", "3")
    with open(out, "rb") as f:
        ids3 = list(pickle.load(f)["video-id"])
    assert len(ids) < len(ids3) <= 3 * len(set(ids3))


def test_cli_fuses_an_external_score_file(golden, tmp_path):
    """test_cfg.ext_score_file goes through postprocess_results: the mAP is
    the JAX evaluator's on the JAX fusion of the JAX detections."""
    rng = np.random.default_rng(9)
    vids = sorted(set(golden["jax_results"]["video-id"]))
    scores = tmp_path / "cls.json"
    scores.write_text(json.dumps({v: rng.uniform(0, 1, NCLS).tolist() for v in vids}))
    d = dict(golden["cfg_dict"], test_cfg=dict(golden["cfg_dict"]["test_cfg"],
                                               ext_score_file=str(scores)))
    cfg_yaml = str(tmp_path / "cfg.yaml")
    with open(cfg_yaml, "w") as f:
        yaml.safe_dump(d, f)
    got = _cli(golden, golden["ckpt"], cfg_yaml=cfg_yaml)
    ev = jmetrics.ANETdetection(golden["synth"]["json_file"], "validation",
                                tiou_thresholds=np.linspace(0.1, 0.9, 9), num_workers=1)
    _, ref = ev.evaluate(jpost.postprocess_results(golden["jax_results"], str(scores)),
                         verbose=False)
    assert abs(got - ref) <= 1e-6 and abs(got - golden["jax_map"]) > 1e-3


def test_cli_refuses_a_msgpack_folder_and_an_empty_split(golden, tmp_path):
    """A JAX checkpoint folder (msgpack, written by the JAX save_checkpoint
    with its optimizer state) is served: its EMA weights (the golden ones;
    its params are not) give the JAX eval CLI's mAP within 1e-6. An empty
    split is still refused."""
    import argparse

    import jax

    import eval as jax_cli
    from unav_yolyolva_tpu.train.checkpoint import save_checkpoint

    state = golden["state"]
    state = state.replace(params=jax.tree.map(lambda p: p * 0.5, state.params))
    folder = str(tmp_path / "jax_ckpt")
    save_checkpoint(state, 1, folder, file_name="epoch_001")
    ref = jax_cli.main(argparse.Namespace(config=golden["cfg_yaml"], ckpt=folder, topk=-1,
                                          saveonly=False, print_freq=10))
    got = _cli(golden, folder)
    assert abs(got - ref) <= 1e-6
    assert abs(got - float(np.load(GOLDEN)["avg_map"])) <= 1e-6
    d = dict(golden["cfg_dict"], test_split=["no_such_split"])
    cfg_yaml = str(tmp_path / "cfg.yaml")
    with open(cfg_yaml, "w") as f:
        yaml.safe_dump(d, f)
    with pytest.raises(ValueError, match="matched no videos"):
        _cli(golden, golden["ckpt"], cfg_yaml=cfg_yaml)


def test_cli_runs_as_a_module(golden):
    """`python -m unav_yolyolva_tpu_torch.eval.cli ... --device cpu` prints
    the golden average mAP (its data workers re-import the CLI module)."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-m", "unav_yolyolva_tpu_torch.eval.cli",
                          golden["cfg_yaml"], golden["ckpt"], "--device", "cpu"],
                         cwd=root, env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    want = f"Average mAP: {float(np.load(GOLDEN)['avg_map']) * 100:.2f} (%)"
    assert want in res.stdout, res.stdout
