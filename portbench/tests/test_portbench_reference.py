"""The frozen reference (portbench/reference/) held to the program's plain
path on the CPU at a tiny width: the eval detections, and the losses,
first gradient and parameters of the train step at float32; and the FLOP
counts pinned in the configuration files held to the program's
tools/flops.py at the full width."""

import copy

import pytest
import torch

from _portbench_common import TINY
from portbench import check, common, flops, run, spec, traffic
from portbench.modes import train as train_mode
from portbench.reference import decode as ref_decode
from portbench.reference import model as ref_model


def _cell(workload, dtype=None, **mix):
    w = spec.cell(spec.benchmark(), workload)
    cfg = run._deep_update(copy.deepcopy(w["config_file"]["config"]), TINY)
    if dtype:
        cfg["tpu"]["compute_dtype"] = dtype
    return w, cfg, run._deep_update(copy.deepcopy(w["traffic_file"]), dict(batch=4, pool=3, **mix))


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_eval_detections_match_the_program(seed):
    from unav_yolyolva_tpu_torch.eval.step import make_eval_step

    w, cfg, mix = _cell("eval_fp32_b64")
    dev = torch.device("cpu")
    state = common.make_weights(cfg, seed, dev)
    batch = traffic.pool(seed, mix, cfg, dev)[0]
    prog = make_eval_step(common.program_model(cfg, state, dev), cfg, device=dev)(batch)
    model = common.reference_model(cfg, state, dev).eval()
    with torch.no_grad():
        out = model({"visual": batch["visual"], "audio": batch["audio"], "mask": batch["mask"]})
    pts = [torch.from_numpy(p) for p in ref_model.generate_points(
        64, cfg["model"]["regression_range"], 2)]
    ref = ref_decode.detections(out, pts, batch, cfg["test_cfg"])
    assert torch.equal(prog["valid"], ref["valid"]) and torch.equal(prog["labels"].long(),
                                                                    ref["labels"])
    torch.testing.assert_close(prog["scores"], ref["scores"], rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(prog["segments"], ref["segments"], rtol=1e-5, atol=1e-5)
    tol = check.judge("eval_fp32_b64")["video_tol"]
    cand = check.reference_candidates(model, cfg, batch, dev, tol)
    gaps = check.replay_gaps(prog, cand, cfg["test_cfg"], tol)
    assert float(gaps.max()) < 1e-5


def test_train_step_matches_the_program_at_fp32():
    w, cfg, mix = _cell("train_bf16_b64", dtype="float32")
    dev = torch.device("cpu")
    iters = w["config_file"]["iters_per_epoch"]
    n, count = check.judge("train_bf16_b64")["checked_steps"], train_mode.resume_count(mix, iters)
    assert count > cfg["opt"]["warmup_epochs"] * iters
    state_dict = common.make_weights(cfg, 11, dev)
    pool = traffic.pool(12, mix, cfg, dev)
    st, step = train_mode._program(cfg, state_dict, iters, count, dev)
    assert st.optimizer.count == count and st.step == count
    prog = train_mode.first_steps(st, step, pool, 13, mix, n)
    assert st.optimizer.count == count + mix["warm"]
    ref = train_mode.reference_steps(cfg, state_dict, pool, 13, n, iters, count, dev)
    for p, r in zip(prog["losses"], ref["losses"]):
        for k in r:
            assert p[k] == pytest.approx(r[k], rel=1e-5, abs=1e-7), k
    nums = check.compare_train(prog, ref, state_dict)
    assert nums["grad_gap"] < 1e-4 and nums["update_worst"] < 1e-3 and nums["ema_p90"] < 1e-3
    for what in ("params", "ema"):
        for k, v in ref[what].items():
            # an update moves an element by ~2.5 x lr = 2.4e-4; an element whose
            # gradient is near nought may move differently by rounding
            torch.testing.assert_close(prog[what][k], v, rtol=1e-5, atol=1e-6)
            # past the warmup every leaf that learns has moved, and its EMA with it
            if k in check.moving_leaves(ref["grad1"]):
                assert not torch.equal(v, state_dict[k]), (what, k)


def test_decay_partition_is_the_programs():
    from unav_yolyolva_tpu_torch.train.optim import decay_mask

    _, cfg, _ = _cell("eval_fp32_b64")
    model = common.program_model(cfg, common.make_weights(cfg, 1, "cpu"), torch.device("cpu"))
    from portbench.reference.train import decays

    assert {n: decays(n) for n, _ in model.named_parameters()} == decay_mask(model)


def test_pinned_flops_are_the_programs_count():
    from unav_yolyolva_tpu_torch.tools.flops import model_flops

    for name in ("unav100_fp32", "unav100_bf16"):
        doc = spec.cell(spec.benchmark(), {"unav100_fp32": "eval_fp32_b64",
                                           "unav100_bf16": "train_bf16_b64"}[name])["config_file"]
        cfg, pinned, b = doc["config"], doc["flops"], doc["flops"]["batch"]
        assert pinned["eval_per_video"] == model_flops(cfg, b, False) / b
        assert pinned["train_per_clip"] == model_flops(cfg, b, True) / b
    assert round(pinned["eval_per_video"] / 1e9, 2) == 28.70
    assert round(pinned["train_per_clip"] / 1e9, 2) == 85.66


def test_reference_counts_the_pinned_flops():
    doc = spec.cell(spec.benchmark(), "eval_fp32_b64")["config_file"]
    b = doc["flops"]["batch"]       # the contrastive loss's logits grow as the batch squared
    assert flops.model_flops(doc["config"], b, False) / b == doc["flops"]["eval_per_video"]
    assert flops.model_flops(doc["config"], b, True) / b == doc["flops"]["train_per_clip"]


def _tiny_cell(workload, **mix):
    w = copy.deepcopy(spec.cell(spec.benchmark(), workload))
    run._deep_update(w["config_file"]["config"], TINY)
    run._deep_update(w["traffic_file"], dict(batch=4, pool=3, **mix))
    return w


def _fails(nums, limits):
    return any(nums[k] > v for k, v in limits.items())


@pytest.mark.parametrize("seed", [41, 42, 43])
def test_eval_control_is_not_correct(seed):
    """The reference at TF32 in the program's place fails the cell's limits,
    where the program passes them (on the chip at the cell's size: PERF.md)."""
    from portbench import calibrate

    w = _tiny_cell("eval_fp32_b64")
    lines = {x["side"]: x for x in calibrate.eval_seed(w, seed, ["program", "control"], False,
                                                        torch.device("cpu"))}
    limits = check.limits("eval_fp32_b64")
    assert not _fails(lines["program"], limits) and _fails(lines["control"], limits)


@pytest.mark.parametrize("seed", [44, 45, 46])
def test_train_control_and_half_batch_are_not_correct(seed):
    """The reference at fp8 in the program's place, and the reference on
    half of each batch, fail the train cell's limits (on the chip at the
    cell's size: PERF.md)."""
    w = _tiny_cell("train_bf16_b64")
    lines = {x["side"]: x for x in train_mode.calibrate_seed(w, seed, ["control"],
                                                               torch.device("cpu"))}
    limits = check.limits("train_bf16_b64")
    assert _fails(lines["control"], limits) and _fails(lines["half_batch"], limits)
