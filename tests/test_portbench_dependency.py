"""The benchmark's configuration with the dependency block (`unav100_dep`):
its plain reference (portbench/reference/dependency.py) against the
program on seeded random weights at a small size on the CPU (the block
alone, its class-major mask tiling, the whole detector's logits, offsets
and detections with padded frames), the reference's imports, the block's
kernel calls and FLOP count, the eval_dep mode end to end on the CPU and
read by the eval readers, and faults the check must catch.

Tolerances: the program's plain path and the reference compute the same
fp32 arithmetic in another order (the program's MHCA and convolutions
through its own plain versions), so values agree to fp32 round-off grown
through the layers: rtol 1e-4 with an atol of 1e-5 of the compared
tensor's largest magnitude; the detections as test_portbench_reference.py
holds the model without the block (scores rtol 1e-5, segments 1e-5)."""

from __future__ import annotations

import ast
import copy
import json
import os
import subprocess
import sys

import pytest
import torch

from _torch_port_common import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "portbench", "tests"))

from _portbench_common import TINY, TINY_MIX  # noqa: E402  (puts the repository on the path)
from portbench import check, common, flops_dependency, run, spec, weights, work  # noqa: E402
from portbench import work_dependency  # noqa: E402
from portbench.modes import eval_dep  # noqa: E402
from portbench.reference import decode as ref_decode  # noqa: E402
from portbench.reference import dependency as ref_dep  # noqa: E402
from portbench.reference import model as ref_model  # noqa: E402

CELL = "eval_dep_fp32_b64"
# B=2, T=32, 4 classes, arch (2, 2, 2): three pyramid levels
SMALL = {"dataset": {"num_classes": 4, "max_seq_len": 32, "max_num_events": 8,
                     "backbone_arch": [2, 2, 2],
                     "regression_range": [[0, 4], [4, 8], [8, 10000]]},
         "model": {"raw_input_dim_V": 64, "raw_input_dim_A": 16, "input_dim_V": 32,
                   "input_dim_A": 32, "embd_dim": 32, "head_dim": 32, "num_classes": 4,
                   "max_seq_len": 32, "backbone_arch": [2, 2, 2],
                   "regression_range": [[0, 4], [4, 8], [8, 10000]]},
         "test_cfg": {"pre_nms_topk": 100, "max_seg_num": 20}}


def _config(over=SMALL):
    doc = spec.cell(spec.benchmark(), CELL)["config_file"]
    return run._deep_update(copy.deepcopy(doc["config"]), over)


def _close(got, want, what):
    scale = float(want.abs().max()) or 1.0
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * scale, msg=what)


# ---- the block alone ------------------------------------------------------------

CIN, NCLS = 24, 5


def _blocks(seed=7):
    from unav_yolyolva_tpu_torch.models.dependency import DependencyBlock

    ref = ref_dep.DependencyBlock(CIN, NCLS, 3, 0.1)
    shapes = {k: v.shape for k, v in ref.state_dict().items()}
    state = weights.make(shapes, seed, "cpu")
    ref.load_state_dict(state, strict=True)
    port = DependencyBlock(CIN, 128, 3, NCLS, path_pdrop=0.1, n_head=1)
    port.load_state_dict(state, strict=True)
    return ref.eval(), port.eval()


def _levels(lengths, t=16, seed=8):
    """Two levels (T and T/2) of B = len(lengths) videos, features zero past
    each length; a length of 0 is a row of padded frames only."""
    gen = torch.Generator().manual_seed(seed)
    feats, masks = [], []
    for lv in range(2):
        tl = t >> lv
        ln = torch.tensor([-(-n // (1 << lv)) for n in lengths])
        mask = torch.arange(tl)[None, :] < ln[:, None]
        feats.append(torch.randn(len(lengths), tl, CIN, generator=gen) * mask[..., None])
        masks.append(mask)
    return feats, masks


@pytest.mark.parametrize("lengths", [[16, 16], [16, 9, 0], [5, 16, 11, 1]],
                         ids=["full", "padded", "ragged"])
def test_block_matches_the_program(lengths):
    ref, port = _blocks()
    feats, masks = _levels(lengths)
    with torch.no_grad():
        want = ref(feats, masks)
        got, got_masks = port(feats, masks)
    assert got_masks is masks
    for lv, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == feats[lv].shape
        _close(g, w, f"level {lv}")


def test_block_tiles_the_time_mask_class_major():
    """Both sides give the temporal branch's row k = b * C + c the mask of
    video k mod B (mask.repeat(C, 1)), the reference's quirk, not that of
    video b; and the co-occurrence branch a frame's whole class row."""
    ref, port = _blocks()
    lengths = [16, 9, 3]
    feats, masks = _levels(lengths)
    seen = {}

    def grab(name, at):
        def hook(_mod, args):
            seen.setdefault(name, []).append(args[at])
        return hook

    ref.temporal_branch.register_forward_pre_hook(grab("ref_t", 1))
    ref.cooccur_branch.register_forward_pre_hook(grab("ref_c", 1))
    port.temporal_branch.register_forward_pre_hook(grab("port_t", 2))
    port.cooccur_branch.register_forward_pre_hook(grab("port_c", 2))
    with torch.no_grad():
        ref(feats, masks)
        port(feats, masks)
    b, t = masks[0].shape
    tiled = masks[0].repeat(NCLS, 1)
    assert not torch.equal(tiled, masks[0].repeat_interleave(NCLS, 0))
    assert torch.equal(seen["ref_t"][0], tiled) and torch.equal(seen["port_t"][0], tiled)
    rows = masks[0].reshape(b * t, 1).expand(b * t, NCLS)
    assert torch.equal(seen["ref_c"][0], rows) and torch.equal(seen["port_c"][0], rows)


# ---- the whole detector -------------------------------------------------------------

@pytest.fixture(scope="module")
def detector_outputs():
    from unav_yolyolva_tpu_torch.eval.step import make_eval_step

    torch.set_num_threads(1)
    cfg = _config()
    m = cfg["model"]
    dev = torch.device("cpu")
    state = eval_dep.make_weights(cfg, 2**31 + 77, dev)
    assert set(state) == set(common.program_model(cfg, state, dev).state_dict())
    gen = torch.Generator().manual_seed(9)
    lengths = torch.tensor([32, 11])                  # the second video: 21 padded frames
    mask = torch.arange(32)[None, :] < lengths[:, None]
    fm = mask[..., None].float()
    batch = {"visual": torch.randn(2, 32, m["raw_input_dim_V"], generator=gen) * fm,
             "audio": torch.randn(2, 32, m["raw_input_dim_A"], generator=gen) * fm,
             "mask": mask, "fps": torch.full((2,), 25.0),
             "duration": lengths.float() * 8 / 25.0, "feat_stride": torch.full((2,), 8.0),
             "feat_num_frames": torch.full((2,), 24.0)}
    inputs = {"visual": batch["visual"], "audio": batch["audio"], "mask": mask}
    program = common.program_model(cfg, state, dev).eval()
    reference = eval_dep.reference_model(cfg, state, dev).eval()
    with torch.no_grad():
        prog = program(inputs, with_losses=False)
        ref = reference(inputs)
    dets = make_eval_step(program, cfg, device=dev)(batch)
    points = [torch.from_numpy(p) for p in ref_model.generate_points(
        32, m["regression_range"], m["scale_factor"])]
    return {"cfg": cfg, "state": state, "inputs": inputs, "prog": prog, "ref": ref,
            "prog_dets": dets,
            "ref_dets": ref_decode.detections(ref, points, batch, cfg["test_cfg"])}


@pytest.mark.parametrize("what", ["cls_logits", "offsets"])
def test_detector_outputs_match_the_program(detector_outputs, what):
    prog, ref = detector_outputs["prog"], detector_outputs["ref"]
    assert len(prog[what]) == len(ref[what]) == 3
    for lv, (p, r) in enumerate(zip(prog[what], ref[what])):
        assert p.shape == r.shape
        _close(p, r, f"{what} level {lv}")
    for p, r in zip(prog["masks"], ref["masks"]):
        assert torch.equal(p, r)


def test_detector_detections_match_the_program(detector_outputs):
    prog, ref = detector_outputs["prog_dets"], detector_outputs["ref_dets"]
    assert torch.equal(prog["valid"], ref["valid"]) and int(ref["valid"].sum()) > 0
    assert torch.equal(prog["labels"].long(), ref["labels"])
    torch.testing.assert_close(prog["scores"], ref["scores"], rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(prog["segments"], ref["segments"], rtol=1e-5, atol=1e-5)


def test_the_block_moves_the_detector(detector_outputs):
    """Dropped from the reference, the block changes every level's logits by
    far more than the tolerance: the comparison above sees it."""
    d = detector_outputs
    model = eval_dep.reference_model(d["cfg"], d["state"], torch.device("cpu")).eval()
    model.dependency.forward = lambda feats, masks: feats
    with torch.no_grad():
        without = model(d["inputs"])
    for lv, (a, b) in enumerate(zip(without["cls_logits"], d["ref"]["cls_logits"])):
        assert float((a - b).abs().max()) > 1e-2 * float(b.abs().max()), lv


# ---- imports, counts ----------------------------------------------------------------

def test_reference_imports_no_program_and_no_jax():
    path = os.path.join(ROOT, "portbench", "reference", "dependency.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level <= 1, "the reference imports only within portbench/reference"
            if node.module and node.level == 0:
                names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "flax", "unav_yolyolva_tpu",
                        "unav_yolyolva_tpu_torch", "portbench"}
    script = ("import sys; import portbench.reference.dependency as d; "
              "d.build(" + repr(_config()["model"]) + ", 'meta'); "
              "print(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'flax', 'unav_yolyolva_tpu', 'unav_yolyolva_tpu_torch')))")
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "[]"


def test_block_calls_by_hand():
    cfg = _config({})
    calls = work_dependency.step_calls(cfg, 64, train=False)
    base = work.step_calls(dict(cfg, model=dict(cfg["model"], use_dependency=False)), 64,
                           train=False)
    block = work_dependency.block_calls(cfg, 64)
    assert calls == base + block
    by_hand = []
    for t in (224, 112, 56, 28, 14, 7):
        by_hand += [work.Call("mhca", (6400, t, 128, 1), "float32", 1),
                    work.Call("mhca", (64 * t, 100, 128, 1), "float32", 1)]
    assert block == by_hand
    assert sum(c.count for c in calls if c.entry == "mhca") == 17
    assert [c.entry for c in calls].count("nms") == 1 and not set(block) & set(base)
    flops, nbytes = work.work(block[0])
    assert flops == 8 * 6400 * 224 * 128 ** 2 + 4 * 6400 * 224 ** 2 * 128
    with pytest.raises(NotImplementedError):
        work.step_calls(cfg, 64, train=False)
    with pytest.raises(NotImplementedError):
        work_dependency.step_calls(cfg, 64, train=True)


def test_pinned_flops_are_the_references_count():
    doc = spec.cell(spec.benchmark(), CELL)["config_file"]
    assert doc["parameters"] == sum(s.numel() for s in ref_dep.shapes(doc["config"]["model"])
                                    .values()) == 137487007
    assert flops_dependency.model_flops(doc["config"], 1) == doc["flops"]["eval_per_video"]
    assert round(doc["flops"]["eval_per_video"] / 1e9, 2) == 121.29


# ---- the mode end to end, and faults -------------------------------------------------

@pytest.fixture(autouse=True)
def jax_loaded_before(monkeypatch):
    """The suite's conftest loads JAX before any test; run_cell refuses a
    process with JAX loaded. Here it refuses only what the run itself loads."""
    real = run.forbidden_modules
    before = set(real())
    monkeypatch.setattr(run, "forbidden_modules", lambda: sorted(set(real()) - before))


def _tiny(seed=5, trace=False, seconds=1.0, mix=TINY_MIX):
    return run.run_cell(CELL, seed, seconds, trace, device="cpu", overrides=copy.deepcopy(TINY),
                        mix_overrides=mix)


# A pool of the cell's check_batches (2) batches: every batch the window serves
# is a checked one, so the first batch served is judged however few a loaded
# CPU serves in the window. With the pool of 5, a window that serves only
# unchecked batches compares no video, and its verdict says nothing of the
# answers.
CHECKED_POOL = dict(TINY_MIX, pool=2)


@pytest.mark.parametrize("trace", [False, True])
def test_eval_dep_runs_and_reads_as_eval(trace):
    rc, line = _tiny(seed=2**31 + 3, trace=trace, mix=CHECKED_POOL)
    assert rc == 0 and line["correct"] is True
    w = spec.cell(spec.benchmark(), CELL)
    wanted = {m["name"] for m in w["per_layer" if trace else "end_to_end"]}
    got = set(line["metrics"])
    if trace:       # the card's metrics read nothing on the CPU
        assert got == {"host_ms.eval"} <= wanted
    else:
        assert got == {"videos_per_s", "eval_p95_ms", "setup_s"} == wanted
    assert line["checks"]["videos_off"]["value"] == 0
    json.dumps(line)


def test_eval_dep_record_reads_through_the_eval_readers(monkeypatch):
    """The mode's record is eval's: every eval reader reads it, and the
    block's readers read its spans and its kernel times (planted here, as
    the card would give them)."""
    records = []
    real = eval_dep.run

    def keep(ctx):
        records.append(real(ctx))
        return records[-1]

    monkeypatch.setattr(eval_dep, "run", keep)
    rc, line = _tiny(seed=11, trace=True, mix=CHECKED_POOL)
    assert rc == 0 and line["correct"]
    rec = records[0]
    assert rec["kind"] == "eval" and rec["device"]["platform"] == "cpu"
    assert "unav.eval.step" in rec["span_trace"]["count"]
    for name in ("videos_per_s", "eval_p95_ms", "host_ms.eval", "setup_s"):
        assert spec.reader(name)(rec) is not None, name
    for name in ("device_ms.dependency.eval", "device_ms.dependency_convs.eval",
                 "kernel_roofline.dependency.eval"):
        assert spec.reader(name)(rec) is None, name
    cfg = run._deep_update(copy.deepcopy(spec.cell(spec.benchmark(), CELL)["config_file"]
                                         ["config"]), TINY)
    block = work_dependency.block_calls(cfg, TINY_MIX["batch"])
    alone = [(c, 10 * work.least_seconds(c)) for c in block]
    steps = rec["span_trace"]["count"]["unav.eval.step"]
    planted = dict(rec, kernels=alone, dependency_kernels=alone,
                   span_trace=dict(rec["span_trace"], device_s={
                       "unav.model.dependency": 0.2 * steps, "unav.dependency.expand": 0.03 * steps,
                       "unav.dependency.squeeze": 0.05 * steps}))
    assert spec.reader("device_ms.dependency.eval")(planted) == pytest.approx(200.0)
    assert spec.reader("device_ms.dependency_convs.eval")(planted) == pytest.approx(80.0)
    assert spec.reader("kernel_roofline.dependency.eval")(planted) == pytest.approx(10.0)
    assert spec.reader("kernel_roofline.eval")(planted) == pytest.approx(10.0)


def test_an_altered_answer_is_not_correct(monkeypatch):
    """Every video's top score halved: one checked batch is over the
    videos_off limit (2) on its own, whatever the count of batches served."""
    from unav_yolyolva_tpu_torch.eval import step as step_mod

    real = step_mod.make_eval_step

    def make(*a, **k):
        inner = real(*a, **k)

        def broken(batch):
            dets = {n: v.clone() for n, v in inner(batch).items()}
            dets["scores"][:, 0] *= 0.5
            return dets
        return broken
    monkeypatch.setattr(step_mod, "make_eval_step", make)
    rc, line = _tiny(seed=21, mix=CHECKED_POOL)
    assert rc == 0 and line["correct"] is False


def test_a_reference_without_the_block_is_not_correct(monkeypatch):
    monkeypatch.setattr(ref_dep.DependencyBlock, "forward", lambda self, feats, masks: feats)
    rc, line = _tiny(seed=22, mix=CHECKED_POOL)
    assert rc == 0 and line["correct"] is False
    assert line["checks"]["videos_off"]["value"] > line["checks"]["videos_off"]["limit"]


def test_the_mode_restores_what_it_rebinds():
    before = (common.make_weights, common.reference_model, common.SubWindow, work.step_calls)
    rc, _ = _tiny(seed=23)
    assert rc == 0
    assert (common.make_weights, common.reference_model, common.SubWindow,
            work.step_calls) == before
    assert check.limits(CELL)

