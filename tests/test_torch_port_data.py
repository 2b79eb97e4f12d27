"""The port's data pipeline (synthetic files, UnAV100Dataset, collate, the
Batcher and its worker processes) against the JAX package's, on the CPU:
the same files, items, batches and order, array for array."""

import os
import random
import threading
import time

import numpy as np
import pytest

from unav_yolyolva_tpu.core.config import load_config_dict as jcfg
from unav_yolyolva_tpu.data import UnAV100Dataset as JDataset
from unav_yolyolva_tpu.data import make_batcher as jmake_batcher
from unav_yolyolva_tpu.data import synthetic as jsynthetic
from unav_yolyolva_tpu.data.pipeline import collate as jcollate
from unav_yolyolva_tpu_torch.builders import make_data_loader, make_dataset
from unav_yolyolva_tpu_torch.core import load_config_dict
from unav_yolyolva_tpu_torch.data import Batcher, UnAV100Dataset, make_batcher
from unav_yolyolva_tpu_torch.data.pipeline import collate
from unav_yolyolva_tpu_torch.data.synthetic import make_synthetic_dataset
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)

SYNTH = dict(num_videos=8, num_classes=5, min_len=40, max_len=120, visual_dim=64,
             audio_dim=16, seed=1)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("synth")), **SYNTH)


def cfg_dict(synth, max_seq_len=96, batch_size=2, num_workers=2):
    return {"dataset": {"json_file": synth["json_file"], "feat_folder": synth["feat_folder"],
                        "num_classes": synth["num_classes"], "max_seq_len": max_seq_len,
                        "max_num_events": 8},
            "loader": {"batch_size": batch_size, "num_workers": num_workers}}


def datasets(synth, training, split, max_seq_len=96):
    kw = jcfg(cfg_dict(synth, max_seq_len))["dataset"]
    return JDataset(training, split, **kw), UnAV100Dataset(training, split, **kw)


def assert_batches_equal(port, ref):
    assert sorted(port) == sorted(ref)
    for k, v in ref.items():
        if k == "video_id":
            assert port[k] == v
        else:
            assert port[k].dtype == v.dtype, k
            np.testing.assert_array_equal(port[k], v, err_msg=k)


@pytest.mark.parametrize("args", [dict(SYNTH), dict(SYNTH, num_videos=5, seed=7,
                                                    val_fraction=0.4, events_per_video=2)])
def test_synthetic_files_are_the_jax_writers(tmp_path, args):
    ref = jsynthetic.make_synthetic_dataset(str(tmp_path / "jax"), **args)
    port = make_synthetic_dataset(str(tmp_path / "port"), **args)
    assert port["database"] == ref["database"]
    names = sorted(os.listdir(ref["feat_folder"]))
    assert names == sorted(os.listdir(port["feat_folder"])) and len(names) == 3 * args[
        "num_videos"]
    for a, b in [(os.path.join(ref["feat_folder"], n), os.path.join(port["feat_folder"], n))
                 for n in names] + [(ref["json_file"], port["json_file"])]:
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), b


@pytest.mark.parametrize("max_seq_len", [32, 96])
def test_load_item_with_truncation_is_the_jax_items(synth, max_seq_len):
    jds, pds = datasets(synth, True, ("train",), max_seq_len)
    assert len(pds) == len(jds) == 4
    assert pds.label_dict == jds.label_dict
    assert pds.get_attributes()["empty_label_ids"] == jds.get_attributes()["empty_label_ids"]
    jrng, prng = random.Random(5), random.Random(5)
    for _ in range(3):                       # the streams advance item by item
        for i in range(len(pds)):
            ref, got = jds.load_item(i, jrng), pds.load_item(i, prng)
            assert got["visual"].shape[0] <= max_seq_len
            for k, v in ref.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(got[k], v, err_msg=k)
                else:
                    assert got[k] == v, k


@pytest.mark.parametrize("training", [True, False])
def test_collate_is_the_jax_collate(synth, training):
    """Eval batches holding a video longer than max_seq_len (64) round up to
    the next multiple of the largest stride, as the JAX collate does."""
    jds, pds = datasets(synth, training, ("train", "validation"), 64)
    lens = [pds.load_item(i)["visual"].shape[0] for i in range(len(pds))]
    assert training or max(lens) > 64
    for idxs in ([0, 1], [2, 3, 4], list(range(len(pds)))):
        rng_j, rng_p = random.Random(3), random.Random(3)
        kw = dict(max_seq_len=64, max_num_events=2, training=training, max_div_factor=32)
        ref = jcollate([jds.load_item(i, rng_j) for i in idxs], **kw)
        got = collate([pds.load_item(i, rng_p) for i in idxs], **kw)
        assert_batches_equal(got, ref)
        if not training and max(lens[i] for i in idxs) > 64:
            assert got["visual"].shape[1] % 32 == 0 and got["visual"].shape[1] > 64


@pytest.mark.parametrize("workers", [1, 2])
def test_batcher_is_the_jax_batcher(synth, workers):
    """Train batches over epochs 0 and 1 (crops and order from the seeded
    per-worker streams, the JAX package's per-thread ones) and eval batches,
    batch by batch; the workers serve both epochs."""
    d = cfg_dict(synth, batch_size=2, num_workers=workers)
    jc, pc = jcfg(d), load_config_dict(d)
    for training, split in ((True, ("train",)), (False, ("validation", "train"))):
        jds = JDataset(training, split, **jc["dataset"])
        pds = make_dataset("unav100", training, split, **pc["dataset"])
        jb = jmake_batcher(jds, jc, training, seed=3)
        with make_data_loader(pds, training, pc, seed=3, device="cpu") as pb:
            assert pb.num_workers == workers and len(pb) == len(jb)
            for epoch in ((0, 1) if training else (0,)):
                jb.set_epoch(epoch)
                pb.set_epoch(epoch)
                ref, got = list(jb), list(pb)
                assert len(got) == len(ref) == (2 if training else 4)
                for g, r in zip(got, ref):
                    assert_batches_equal(g, r)


def _workers():
    import multiprocessing

    return [p for p in multiprocessing.active_children() if p.name.startswith("unav-data")]


def test_batcher_early_exit_ends_the_epoch_and_close_joins_the_workers(synth):
    """A consumer that leaves mid-epoch: the copier thread ends, the workers
    drop the rest of the epoch and serve the next one in full; close()
    stops them and their queue threads."""
    pc = load_config_dict(cfg_dict(synth, batch_size=1))
    pc["loader"]["prefetch"] = 1
    ds = UnAV100Dataset(False, ("validation",), **pc["dataset"])
    baseline = threading.active_count()
    b = make_batcher(ds, pc, False, device="cpu")
    for _ in b:
        break
    assert not any(t.name == "unav-batcher-copier" for t in threading.enumerate())
    assert len(_workers()) == 2
    assert [x["video_id"][0] for x in b] == [r.id for r in ds.records]
    b.close()
    assert not _workers()
    deadline = time.time() + 5.0
    while threading.active_count() > baseline and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == baseline


def test_batcher_worker_exception_propagates(synth, tmp_path):
    """A corrupt feature file raises its error in the consumer, with the
    worker's traceback as a note; the next epoch starts new workers."""
    import shutil

    shutil.copytree(synth["feat_folder"], tmp_path / "features")
    d = cfg_dict(synth)
    d["dataset"]["feat_folder"] = str(tmp_path / "features")
    pc = load_config_dict(d)
    ds = UnAV100Dataset(True, ("train",), **pc["dataset"])
    bad = tmp_path / "features" / f"{ds.records[1].id}_rgb.npy"
    good = bad.read_bytes()
    bad.write_bytes(good[:200])
    with make_batcher(ds, pc, True, device="cpu") as b:
        with pytest.raises(ValueError) as err:
            list(b)
        assert any("data worker" in n for n in getattr(err.value, "__notes__", []))
        bad.write_bytes(good)
        assert len(list(b)) == 2


def test_batcher_holds_at_most_prefetch_plus_two_batches(synth):
    """While the consumer holds batch 0, no more than prefetch + 2 batch
    buffers are taken from `empty` (the pinned memory of a CUDA run)."""
    pc = load_config_dict(cfg_dict(synth, batch_size=1, num_workers=4))
    ds = UnAV100Dataset(False, ("validation", "train"), **pc["dataset"])
    made = []

    def counting(shape, dtype):
        made.append(shape)
        return np.empty(shape, dtype)

    got = []
    with Batcher(ds, 1, shuffle=False, drop_last=False, num_workers=4, prefetch=1,
                 empty=counting) as b:
        for batch in b:
            if not got:
                time.sleep(1.0)
                assert len(made) <= 3, made
            got.append(batch["video_id"][0])
    assert got == [r.id for r in ds.records] and len(made) == 8


def test_cuda_batcher_needs_a_card(synth):
    """The default device is CUDA; without a card make_batcher raises."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    pc = load_config_dict(cfg_dict(synth))
    ds = UnAV100Dataset(False, ("validation",), **pc["dataset"])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_batcher(ds, pc, False)


@pytest.mark.parametrize("case", ["f4", "f2_fortran", "i8_3d", "bool_1d", "empty", "v2",
                                  "truncated", "object"])
def test_read_npy_is_np_load(tmp_path, case):
    from unav_yolyolva_tpu_torch.data.dataset import read_npy

    rng = np.random.default_rng(0)
    arr = {"f4": rng.normal(size=(37, 16)).astype(np.float32),
           "f2_fortran": np.asfortranarray(rng.normal(size=(5, 7)).astype(np.float16)),
           "i8_3d": rng.integers(-9, 9, (2, 3, 4)), "bool_1d": rng.random(11) > 0.5,
           "empty": np.zeros((0, 4), np.float32), "v2": rng.normal(size=(3, 2)),
           "truncated": rng.normal(size=(40, 8)).astype(np.float32),
           "object": np.array([{"a": 1}, None], dtype=object)}[case]
    path = tmp_path / "x.npy"
    with open(path, "wb") as f:
        np.lib.format.write_array(f, arr, version=(2, 0) if case == "v2" else None,
                                  allow_pickle=True)
    if case == "truncated":
        path.write_bytes(path.read_bytes()[:-5])
    if case in ("truncated", "object"):
        with pytest.raises(ValueError):
            np.load(path)
        with pytest.raises(ValueError):
            read_npy(str(path))
        return
    got, ref = read_npy(str(path)), np.load(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert got.flags.f_contiguous == ref.flags.f_contiguous
    np.testing.assert_array_equal(got, ref)
