"""PyTorch port vs the JAX package: data parallelism on the CPU.

One module fixture launches a 2-rank gloo run of the port
(`torch.distributed.run --standalone --nproc_per_node 2`,
tests/_torch_parallel_worker.py) while this process compiles the JAX
package's sharded train step over make_mesh(2) and its valid_one_epoch on
the same weights and files; the tests read what both wrote. Config:
tests/test_multihost.py's shared_cfg (T=64, widths 32, 5 classes, global
batch 8, crop_ratio None) with a three-level pyramid.

  * the 2-rank step against the JAX sharded step (SGD, droppath 0, fp32, 2
    steps): losses rtol 2e-4, each parameter's update norm-wise <= 1e-4
    (tests/test_torch_port_train.py's grad tolerance: SGD's update is the
    clipped grad times the learning rate), the normalizer rtol 1e-6;
  * the 2-rank step against the port's 1-process step on the global batch,
    droppath 0.1 and inter_contr_weight 1.0: losses rtol 1e-5, step 1's
    grads norm-wise <= 1e-5 per tensor (only the summation order differs);
    step 2's grads <= 5e-5, against the 1-process run and against a
    1-process step 2 from the 2-rank weights after step 1; the parameters
    and EMA <= 3e-5 (bounds set from the readings in the tests' docstrings);
    both ranks' init, parameters, EMA and normalizer bit-identical;
  * the 2-rank eval epoch from files (eval batch 12: the last batch of 2
    leaves rank 1's block all padding, one blank row): detections equal to
    the 1-process port's at tests/test_torch_port_eval_harness.py's
    tolerances, mAP within 1e-4 of the JAX valid_one_epoch, validation
    losses rtol 1e-5 of the 1-process port's, the pickle written by rank 0
    alone;
  * the train CLI under the 2-rank launch: one folder, written by rank 0
    alone, the learning rate times 2, model_best read back on rank 1;
  * without processes: the Batcher's row blocks against the JAX Batcher's,
    make_mesh's refusals, and no launcher environment = no group and the
    step's bits; the train CLI's wandb gate with a stub module."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import yaml

from tests._torch_port_common import lengths_mask
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, NCLS, NE, B = 64, 5, 8, 8
ARCH = [2, 2, 2]
REG_RANGE = [[0, 4], [4, 8], [8, 10000]]
MODEL = {"raw_input_dim_V": 64, "raw_input_dim_A": 16, "input_dim_V": 32,
         "input_dim_A": 32, "embd_dim": 32, "head_dim": 32, "use_abs_pe": True,
         "class_aware": True, "backbone_arch": ARCH, "regression_range": REG_RANGE}
OPT = {"learning_rate": 1e-2, "epochs": 1, "warmup_epochs": 0, "warmup": False,
       "type": "SGD", "momentum": 0.9, "weight_decay": 0.0}
TEST_CFG = {"pre_nms_topk": 100, "max_seg_num": 20, "min_score": 0.001, "nms_sigma": 0.4,
            "iou_threshold": 0.7}


def shared_cfg(synth):
    return {
        "init_rand_seed": 7,
        "train_split": ["train"], "val_split": ["validation"], "test_split": ["validation"],
        "dataset": {"json_file": synth["json_file"], "feat_folder": synth["feat_folder"],
                    "num_classes": NCLS, "max_seq_len": T, "max_num_events": NE,
                    "crop_ratio": None},
        "loader": {"batch_size": B, "num_workers": 1},
        "model": MODEL, "opt": OPT,
        "train_cfg": {"loss_weight": 1, "droppath": 0.0, "eval_freq": 1},
        "test_cfg": TEST_CFG,
    }


def _train_batch(seed):
    rng = np.random.default_rng(seed)
    lens = rng.integers(20, T + 1, size=B)
    lens[0] = T
    mask = lengths_mask(B, T, lens)
    m = mask[..., None].astype(np.float32)
    starts = rng.uniform(0, 40, size=(B, NE)).astype(np.float32)
    segs = np.stack([starts, starts + rng.uniform(2, 24, size=(B, NE))], -1)
    valid = np.arange(NE)[None, :] < rng.integers(1, 4, size=(B, 1))
    return {"visual": (rng.normal(size=(B, T, 64)) * m).astype(np.float32),
            "audio": (rng.normal(size=(B, T, 16)) * m).astype(np.float32),
            "mask": mask,
            "gt_segments": (segs * valid[..., None]).astype(np.float32),
            "gt_labels": (rng.integers(0, NCLS, size=(B, NE)) * valid).astype(np.int32),
            "gt_valid": valid}


def _jax_state(jc, params, mesh):
    from unav_yolyolva_tpu.train import create_train_state, make_optimizer

    tx, _ = make_optimizer(params, jc["opt"], 2, jc["train_cfg"]["clip_grad_l2norm"])
    return tx, create_train_state(jax.tree.map(jnp.asarray, params), tx,
                                  jc["train_cfg"]["init_loss_norm"], mesh=mesh)


def _jax_side(jc, jc_eval, params, batches):
    """The JAX sharded train step over make_mesh(2) (2 steps) and the JAX
    valid_one_epoch of the EMA weights (= the weights at step 0)."""
    from unav_yolyolva_tpu.data import UnAV100Dataset, make_batcher
    from unav_yolyolva_tpu.eval.metrics import ANETdetection
    from unav_yolyolva_tpu.models import build_model
    from unav_yolyolva_tpu.parallel import make_mesh, shard_batch
    from unav_yolyolva_tpu.train import make_eval_step, make_train_step, valid_one_epoch
    from unav_yolyolva_tpu_torch.utils.convert import params_from_jax

    model = build_model(jc)
    mesh = make_mesh(2)
    tx, state = _jax_state(jc, params, mesh)
    step = make_train_step(model, tx, jc, mesh=mesh)
    losses, trained = [], []
    for b in batches:
        state, lo = step(state, shard_batch(dict(b), mesh), jax.random.PRNGKey(0))
        losses.append({k: float(v) for k, v in lo.items()})
        trained.append({k: v.numpy() for k, v in params_from_jax(
            jax.tree.map(np.asarray, jax.device_get(state.params))).items()})
    normalizer = float(state.loss_normalizer)

    one = make_mesh(1)           # one compiled eval shape: the last batch padded to 12
    _, estate = _jax_state(jc_eval, params, one)
    ds = UnAV100Dataset(False, jc_eval["val_split"], **jc_eval["dataset"])
    ev = ANETdetection(ds.json_file, ds.split[0],
                       tiou_thresholds=ds.get_attributes()["tiou_thresholds"])
    mAP, _ = valid_one_epoch(estate, make_batcher(ds, jc_eval, False, mesh=one),
                             make_eval_step(build_model(jc_eval), jc_eval, mesh=one,
                                            use_ema=True),
                             0, mesh=one, evaluator=ev, print_freq=1000)
    return {"losses": losses, "params": trained, "normalizer": normalizer, "mAP": float(mAP)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from unav_yolyolva_tpu.core.config import load_config_dict as jcfg
    from unav_yolyolva_tpu.models import build_model as jbuild
    from unav_yolyolva_tpu_torch.core import load_config_dict
    from unav_yolyolva_tpu_torch.data.synthetic import make_synthetic_dataset
    from unav_yolyolva_tpu_torch.utils.convert import params_from_jax
    from tests._torch_port_common import np_tree

    root = tmp_path_factory.mktemp("dp")
    in_dir, out_dir = root / "in", root / "out"
    in_dir.mkdir()
    out_dir.mkdir()
    # 28 videos: 14 train (one global batch of 8 an epoch) and 14 validation
    # (eval batch 12: a full batch, then 2 videos, all on rank 0's block)
    synth = make_synthetic_dataset(str(root / "data"), num_videos=28, num_classes=NCLS,
                                   min_len=40, max_len=T, visual_dim=64, audio_dim=16,
                                   seed=5, events_per_video=2)
    base = shared_cfg(synth)
    cfg_b = dict(base, model=dict(MODEL, inter_contr_weight=1.0),
                 train_cfg=dict(base["train_cfg"], droppath=0.1))
    cfg_c = dict(base, loader={"batch_size": 12, "num_workers": 1})
    jc, jc_eval = jcfg(base), jcfg(cfg_c)
    jmodel = jbuild(jc)
    dummy = {"visual": jnp.zeros((2, T, 64)), "audio": jnp.zeros((2, T, 16)),
             "mask": jnp.ones((2, T), bool), "m_scores": jnp.zeros((2, T)),
             "m_start_end": jnp.zeros((2, T)), "m_labels": jnp.zeros((2, T, NCLS))}
    params = np_tree(jax.jit(lambda k, d: jmodel.init(
        {"params": k, "droppath": k}, d, train=False))(jax.random.PRNGKey(0), dummy))
    batches = [_train_batch(40 + i) for i in range(2)]
    torch.save({"cfg_a": load_config_dict(base), "cfg_b": load_config_dict(cfg_b),
                "cfg_c": load_config_dict(cfg_c), "sd": params_from_jax(params),
                "batches": batches}, in_dir / "inputs.pt")
    cli_cfg = dict(base, output_folder=str(root / "ckpt"), tpu={"num_devices": 2})
    with open(in_dir / "train.yaml", "w") as f:
        yaml.safe_dump(cli_cfg, f)

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_", "PYTEST_"))}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    log_path = root / "worker.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", os.path.join(ROOT, "tests", "_torch_parallel_worker.py"),
             str(in_dir), str(out_dir)],
            cwd=str(root), env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            ref = _jax_side(jc, jc_eval, params, batches)
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert rc == 0, log_path.read_text()[-6000:]
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return {"ranks": ranks, "jax": ref, "root": root, "out_dir": out_dir,
            "lr": OPT["learning_rate"], "log": log_path.read_text()}


def _norm_close(got, ref, tol, what):
    """Per tensor ||got - ref|| <= tol ||ref||; a tensor whose reference is
    below 1e-6 of the largest holds rounding noise only and must stay there.
    Returns the largest error."""
    zero = 1e-6 * max(np.linalg.norm(v) for v in ref.values())
    worst = 0.0
    for name, r in ref.items():
        g = got[name]
        if np.linalg.norm(r) < zero:
            assert np.linalg.norm(g) < zero, (what, name)
            continue
        err = np.linalg.norm(g - r) / np.linalg.norm(r)
        assert err <= tol, (what, name, err)
        worst = max(worst, float(err))
    return worst


def test_the_launch_is_two_gloo_ranks(run):
    r0, r1 = run["ranks"]
    assert (r0["rank"], r1["rank"]) == (0, 1)
    assert r0["world_size"] == r1["world_size"] == 2
    assert r0["backend"] == "gloo"


def test_dp_train_step_matches_the_jax_sharded_step(run):
    """2 SGD steps at droppath 0: losses rtol 2e-4, the update of each
    parameter after each step norm-wise <= 1e-4, the normalizer rtol 1e-6."""
    got, ref = run["ranks"][0]["train_a"], run["jax"]
    for g, r in zip(got["losses"], ref["losses"]):
        for k in ("final_loss", "cls_loss", "reg_loss", "inter_contr_loss",
                  "intra_contr_loss", "score_loss_video", "score_loss_audio"):
            np.testing.assert_allclose(g[k], r[k], rtol=2e-4, atol=1e-7, err_msg=k)
        assert g["num_pos"] == r["num_pos"]
    init = got["init"]
    for i, (gp, rp) in enumerate(zip(got["params"], ref["params"])):
        _norm_close({k: gp[k] - init[k] for k in init}, {k: rp[k] - init[k] for k in init},
                    1e-4, f"update after step {i + 1}")
    np.testing.assert_allclose(got["normalizer"], ref["normalizer"], rtol=1e-6)


def test_dp_train_step_matches_the_one_process_step(run):
    """droppath 0.1 (the global batch's draw) and inter weight 1.0 (every
    rank's negatives): losses of both steps rtol 1e-5, the summed grads of
    step 1 norm-wise <= 1e-5 per tensor (both runs start from the same
    weights: only the summation order differs)."""
    tb = run["ranks"][0]["train_b"]
    dp, single = tb["dp"], tb["single"]
    for g, r in zip(dp["losses"], single["losses"]):
        for k, v in r.items():
            np.testing.assert_allclose(g[k], v, rtol=1e-5, atol=1e-8, err_msg=k)
    assert dp["losses"][0]["inter_contr_loss"] > 1e-3          # not hidden under its weight
    print("grads of step 1:", _norm_close(dp["grads"][0], single["grads"][0], 1e-5,
                                          "grads of step 1"))


def test_dp_step_2_matches_one_process_from_the_same_weights(run):
    """Step 2 (the second gradient sum and droppath draw) against the
    1-process step 2 run from the data-parallel weights and normalizer
    after step 1, so that again only the summation order differs: losses
    rtol 1e-5, grads norm-wise <= 5e-5 per tensor. Measured on the CPU:
    1.2e-5 at most (the inter logit scale and the alignment's video tower,
    which the inter loss's gradient reaches), against 4.5e-6 at step 1: a
    second gradient sum or draw that went wrong moves them by orders more.
    The tests print their largest errors (pytest -rP)."""
    tb = run["ranks"][0]["train_b"]
    dp, again = tb["dp"], tb["single_from_dp"]
    for k, v in again["losses"].items():
        np.testing.assert_allclose(dp["losses"][1][k], v, rtol=1e-5, atol=1e-8, err_msg=k)
    print("grads of step 2, same weights:", _norm_close(dp["grads"][1], again["grads"], 5e-5,
                                                        "grads of step 2, same weights"))


def test_dp_state_after_2_steps_matches_the_one_process_run(run):
    """The two runs of test_dp_train_step_matches_the_one_process_step held
    to the end: step 2's grads norm-wise <= 5e-5 per tensor, the parameters
    after each step and the EMA after 2 steps <= 3e-5, the normalizers
    equal (an integer positive count). Measured on the CPU: grads 1.5e-5,
    parameters 4.5e-6 and 7.7e-6, EMA 2.1e-6 at most."""
    tb = run["ranks"][0]["train_b"]
    dp, single = tb["dp"], tb["single"]
    print("grads of step 2:", _norm_close(dp["grads"][1], single["grads"][1], 5e-5,
                                          "grads of step 2"))
    for i, (g, r) in enumerate(zip(dp["params"], single["params"])):
        print(f"params after step {i + 1}:", _norm_close(g, r, 3e-5, f"params after step {i + 1}"))
    print("EMA after step 2:", _norm_close(dp["ema"], single["ema"], 3e-5, "EMA after step 2"))
    assert [n.tobytes() for n in dp["normalizers"]] == [n.tobytes()
                                                       for n in single["normalizers"]]


@pytest.mark.parametrize("case", ["train_a", "train_b"])
def test_the_ranks_stay_bit_identical(run, case):
    """The same init from the seed with no communication, then the same
    parameters, EMA and loss normalizer after 2 steps on both ranks."""
    a, b = (r[case] if case == "train_a" else r[case]["dp"] for r in run["ranks"])
    for what in ("init", "ema"):
        for k in a[what]:
            assert a[what][k].tobytes() == b[what][k].tobytes(), (what, k)
    for pa, pb in zip(a["params"], b["params"]):
        for k in pa:
            assert pa[k].tobytes() == pb[k].tobytes(), k
    assert a["normalizer"].tobytes() == b["normalizer"].tobytes()
    assert a["losses"] == b["losses"]


def test_dp_eval_serves_a_blank_block(run):
    """Eval batch 12 over 2 ranks: blocks of 6; the last batch of 2 videos
    is rank 0's two rows and one blank template row on rank 1."""
    assert run["ranks"][0]["eval"]["dp"]["blocks"] == [6, 2]
    assert run["ranks"][1]["eval"]["dp"]["blocks"] == [6, 1]
    assert run["ranks"][0]["eval"]["single"]["blocks"] == [12, 2]


@pytest.mark.parametrize("rank", [0, 1])
def test_dp_eval_detections_match_one_process(run, rank):
    """Every rank holds every row's detections, equal to the 1-process
    port's: validity and labels exact, segments and scores rtol 1e-4."""
    ev = run["ranks"][rank]["eval"]
    dp, single = ev["dp"], ev["single"]
    assert dp["ids"] == single["ids"] and len(dp["ids"]) == 14
    n = 0
    for d, s in zip(dp["dets"], single["dets"]):
        np.testing.assert_array_equal(d["valid"], s["valid"])
        ok = s["valid"].astype(bool)
        n += int(ok.sum())
        np.testing.assert_array_equal(d["labels"][ok], s["labels"][ok])
        np.testing.assert_allclose(d["segments"][ok], s["segments"][ok], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(d["scores"][ok], s["scores"][ok], rtol=1e-4, atol=1e-5)
    assert n > 0


def test_dp_eval_map_matches_jax(run):
    """The 2-rank mAP (the same on both ranks) within 1e-4 of the JAX
    package's valid_one_epoch on the same files and weights."""
    maps = [r["eval"]["dp"]["mAP"] for r in run["ranks"]]
    assert maps[0] == maps[1]
    assert abs(maps[0] - run["jax"]["mAP"]) <= 1e-4
    assert abs(maps[0] - run["ranks"][0]["eval"]["single"]["mAP"]) <= 1e-4


def test_dp_eval_losses_match_one_process(run):
    for r in run["ranks"]:
        dp, single = r["eval"]["dp"]["losses"], r["eval"]["single"]["losses"]
        assert set(dp) == set(single) and np.isfinite(list(dp.values())).all()
        for k, v in single.items():
            np.testing.assert_allclose(dp[k], v, rtol=1e-5, atol=1e-8, err_msg=k)


def test_only_rank0_writes_the_detections(run):
    assert run["ranks"][0]["eval"]["dp"]["wrote_pickle"]
    assert not run["ranks"][1]["eval"]["dp"]["wrote_pickle"]
    assert not (run["out_dir"] / "dets_dp_rank1.pkl").exists()


def test_cli_writes_one_folder_from_rank0(run):
    c0, c1 = (r["cli"] for r in run["ranks"])
    assert c0["folder"] == c1["folder"] and c0["world_size"] == 2
    assert os.path.isdir(c0["folder"])
    assert {"config.txt", "epoch_000"} <= set(c0["listing"])
    assert c0["saved"] and "epoch_000" in c0["saved"]
    assert c1["saved"] == []
    assert any(p.endswith("config.txt") for p in c0["opened"])
    assert not [p for p in c1["opened"] if p.startswith(str(run["root"]))], c1["opened"]
    assert c0["mAPs"] == c1["mAPs"]


def test_cli_scales_the_learning_rate_by_the_world_size(run):
    folder = run["ranks"][0]["cli"]["folder"]
    with open(os.path.join(folder, "config.txt")) as f:
        cfg = ast.literal_eval(f.read())
    assert cfg["opt"]["learning_rate"] == pytest.approx(2 * run["lr"], rel=1e-12)
    assert cfg["tpu"]["num_devices"] == 2


def test_cli_reads_model_best_back_on_every_rank(run):
    """model_best is written by rank 0 behind a barrier; the final pass on
    its raw weights runs on both ranks, which get the same mAP."""
    c0, c1 = (r["cli"] for r in run["ranks"])
    assert c0["best_mAP"] > 0 and "model_best" in c0["listing"]
    assert c0["final_mAP"] is not None and c0["final_mAP"] == c1["final_mAP"]


# ---- without processes ---------------------------------------------------------

class _Recorder:
    """A JAX dataset that records the items its Batcher loads."""

    def __init__(self, ds):
        self.ds, self.loaded = ds, []

    def __getattr__(self, name):
        return getattr(self.ds, name)

    def __len__(self):
        return len(self.ds)

    def load_item(self, j, rng=None):
        self.loaded.append(j)
        return self.ds.load_item(j, rng)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from unav_yolyolva_tpu_torch.data.synthetic import make_synthetic_dataset

    root = tmp_path_factory.mktemp("dp_files")
    return make_synthetic_dataset(str(root), num_videos=30, num_classes=NCLS, min_len=20,
                                  max_len=T, visual_dim=8, audio_dim=4, seed=2,
                                  events_per_video=1)


@pytest.mark.parametrize("count", [2, 4])
@pytest.mark.parametrize("training", [True, False])
def test_batcher_row_blocks_match_jax(files, count, training):
    """Per process: the train Batcher's row block of every global batch, and
    the eval Batcher's rows_local loads (a blank block loads its batch's
    first item for the template row) and video ids, against the JAX
    Batcher's."""
    from unav_yolyolva_tpu.data import Batcher as JBatcher
    from unav_yolyolva_tpu.data import UnAV100Dataset as JDataset
    from unav_yolyolva_tpu_torch.data import Batcher, UnAV100Dataset

    kw = {"json_file": files["json_file"], "feat_folder": files["feat_folder"],
          "num_classes": NCLS, "max_seq_len": T, "crop_ratio": None}
    split = ["train"] if training else ["validation"]
    jds, pds = _Recorder(JDataset(training, split, **kw)), UnAV100Dataset(training, split, **kw)
    batch = 8 if training else 6                       # eval: 15 videos, a last batch of 3
    pad_to = 0 if training else -(-batch // count) * count
    for pid in range(count):
        jb = JBatcher(jds, batch, shuffle=training, drop_last=training, seed=3, num_threads=1,
                      process_index=pid, process_count=count, pad_to=pad_to)
        pb = Batcher(pds, batch, shuffle=training, drop_last=training, seed=3,
                     process_index=pid, process_count=count, pad_to=pad_to)
        assert pb.rows_local == jb.rows_local == (not training)
        assert pb._index_batches() == jb._index_batches()
        if training:
            assert all(len(b) == batch // count for b in pb._index_batches())
            continue
        jds.loaded.clear()
        ids = [b["video_id"] for b in jb]
        work = [pb._work(b) for b in pb._index_batches()]
        assert [j for load, _, _ in work for j in load] == jds.loaded
        assert [w[2] for w in work] == ids
        blank = [w[1] for w in work]
        assert blank == [len(b[(pid * pad_to // count):]) == 0 for b in pb._index_batches()]


def _clear_launcher(monkeypatch):
    from unav_yolyolva_tpu_torch.parallel.mesh import LAUNCHER_ENV

    for k in LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)


def test_num_devices_must_equal_the_world_size(monkeypatch):
    from unav_yolyolva_tpu_torch.parallel import make_mesh

    _clear_launcher(monkeypatch)
    with pytest.raises(ValueError, match="num_devices is 2 but the world size is 1"):
        make_mesh(2, "cpu")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29599")
    with pytest.raises(ValueError, match="num_devices is 4 but the world size is 2"):
        make_mesh(4, "cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("given", [("RANK",), ("WORLD_SIZE", "LOCAL_RANK"),
                                   ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")])
def test_a_partial_launcher_environment_raises(monkeypatch, given):
    from unav_yolyolva_tpu_torch.parallel import make_mesh

    _clear_launcher(monkeypatch)
    for k in given:
        monkeypatch.setenv(k, "0" if k != "MASTER_ADDR" else "localhost")
    with pytest.raises(RuntimeError, match="partial launcher environment"):
        make_mesh(-1, "cpu")
    assert not torch.distributed.is_initialized()


def test_no_launcher_environment_is_one_process_and_the_same_step(monkeypatch):
    """No group is made, and the train step with that mesh gives the bits
    of the step made without one (droppath on)."""
    from unav_yolyolva_tpu_torch.core import load_config_dict
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.parallel import make_mesh
    from unav_yolyolva_tpu_torch.train import create_train_state, make_optimizer, make_train_step

    _clear_launcher(monkeypatch)
    mesh = make_mesh(-1, "cpu")
    assert (mesh.rank, mesh.world_size, mesh.group, mesh.is_main) == (0, 1, None, True)
    assert not torch.distributed.is_initialized()
    cfg = load_config_dict({"dataset": {"num_classes": NCLS, "max_seq_len": T,
                                        "max_num_events": NE},
                            "model": MODEL, "train_cfg": {"droppath": 0.1}})
    batch = {k: v[:2] for k, v in _train_batch(9).items()}
    runs = []
    for m in (None, mesh):
        model = build_model(cfg, device="cpu", seed=1)
        opt, _ = make_optimizer(model, cfg["opt"], 2)
        state = create_train_state(model, opt, 100.0)
        losses = make_train_step(model, opt, cfg, device="cpu", mesh=m)(state, batch, 5)
        runs.append((losses, [p.detach().clone() for p in model.parameters()]))
    (l0, p0), (l1, p1) = runs
    assert all(torch.equal(l0[k], l1[k]) for k in l0)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


@pytest.mark.parametrize("debugger,fails", [(False, False), (True, False), (False, True)])
def test_train_cli_wandb_gate(monkeypatch, debugger, fails):
    """wandb logs unless a debugger is attached, when it imports and its
    init succeeds (a stub module stands in for wandb)."""
    import types

    from unav_yolyolva_tpu_torch.train import cli
    from unav_yolyolva_tpu_torch.utils import seed as seed_mod

    calls = []

    def init(**kw):
        calls.append(kw)
        if fails:
            raise RuntimeError("no login")
        return types.SimpleNamespace(log=lambda *a, **k: None, finish=lambda: None)

    monkeypatch.setitem(sys.modules, "wandb", types.SimpleNamespace(init=init))
    monkeypatch.setattr(seed_mod, "debugger_is_active", lambda: debugger)
    run = cli._wandb("a_run", cli.parse_args(["cfg.yaml"]))
    assert (run is not None) == (not debugger and not fails)
    assert len(calls) == (0 if debugger else 1)
    if calls:
        assert calls[0]["project"] == "DEL_UnAV" and calls[0]["name"] == "a_run"
        assert calls[0]["group"] == "training_alignment_contrastive_yolyolVA_tpu"
        assert calls[0]["config"]["config"] == "cfg.yaml"


def test_train_cli_logs_to_wandb_on_rank0(monkeypatch, tmp_path):
    """The fields the root train.py logs: each epoch's train losses as
    train_epoch_<name> and the validation mAP as val_epoch_mAP, at step
    epoch; the run is finished at the end."""
    import types

    from unav_yolyolva_tpu_torch.data.synthetic import make_synthetic_dataset
    from unav_yolyolva_tpu_torch.parallel.mesh import LAUNCHER_ENV
    from unav_yolyolva_tpu_torch.train import cli
    from unav_yolyolva_tpu_torch.utils import seed as seed_mod

    for k in LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)
    logged, finished = [], []
    run = types.SimpleNamespace(log=lambda d, step: logged.append((step, dict(d))),
                                finish=lambda: finished.append(True))
    monkeypatch.setitem(sys.modules, "wandb", types.SimpleNamespace(init=lambda **kw: run))
    monkeypatch.setattr(seed_mod, "debugger_is_active", lambda: False)
    synth = make_synthetic_dataset(str(tmp_path / "data"), num_videos=8, num_classes=NCLS,
                                   min_len=20, max_len=T, visual_dim=8, audio_dim=4, seed=4,
                                   events_per_video=1)
    cfg = shared_cfg(synth)
    cfg.update(output_folder=str(tmp_path / "ckpt"),
               model=dict(MODEL, raw_input_dim_V=8, raw_input_dim_A=4),
               loader={"batch_size": 4, "num_workers": 1})
    with open(tmp_path / "c.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    cli.main(cli.parse_args([str(tmp_path / "c.yaml"), "--device", "cpu", "-p", "100"]))
    assert finished == [True]
    steps = [s for s, _ in logged]
    assert steps == [0, 0]
    assert set(logged[0][1]) == {"val_epoch_mAP"}
    assert "train_epoch_final_loss" in logged[1][1] and "train_epoch_num_pos" in logged[1][1]
