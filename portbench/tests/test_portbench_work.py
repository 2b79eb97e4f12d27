"""The kernel work functions (portbench/work.py) at the protocol shapes,
held to the product counts of chip_smoke.py's mhca_products and
csp_products, worked out by hand here."""

import copy

import pytest

import _portbench_common  # noqa: F401
from portbench import spec, work

R, T, C = 64, 224, 512          # the stem's MHCA: B=64, T=224, C=512
MID, CIN, NG, FG = 256, 1024, 512, 224


def test_mhca_products_by_hand():
    # q, k, v, proj: 4 products of (R*T, C) x (C, C), 2 FLOPs a term
    dense = 4 * 2 * R * T * C * C
    # QK^T and PV: 2 products of (T, d) x (d, T) per head and row, summed over heads
    attn = 2 * 2 * R * T * T * C
    assert work.mhca_products(R, T, C) == dense + attn == 8 * R * T * C * C + 4 * R * T * T * C


@pytest.mark.parametrize("t", [224, 112, 56, 28, 14, 7])
def test_csp_products_by_hand(t):
    r = 2 * R
    main = 2 * r * t * CIN * 2 * MID            # main 1x1 conv to 2 mid
    mhca = 3 * (8 * r * t * MID * MID + 4 * r * t * t * MID)
    guide_fc = 2 * r * NG * FG * MID            # guide tokens (C of them) of width T
    proj = 2 * r * t * 3 * MID * MID            # the k=3 projection conv, as one product
    final = 2 * r * t * 6 * MID * C             # final conv over the six parts
    chip_smoke = main + mhca + guide_fc + proj + final
    gate_scores = 2 * r * t * MID * NG          # the gate's scores, which chip_smoke left out
    assert work.csp_products(r, t, CIN, MID, NG, FG, C) == chip_smoke + gate_scores


def test_backward_is_twice_the_forward():
    f, _ = work.work(work.Call("mhca", (R, T, C, 4), "bfloat16", 1))
    b, _ = work.work(work.Call("mhca_backward", (R, T, C, 4), "bfloat16", 1))
    assert b == 2 * f


def test_step_calls_at_the_protocol():
    cfg = spec.cell(spec.benchmark(), "eval_fp32_b64")["config_file"]["config"]
    calls = work.step_calls(cfg, 64, train=False)
    by = {}
    for c in calls:
        by.setdefault(c.entry, []).append(c)
    assert sum(c.count for c in by["mhca"]) == 5          # 4 in the stem, the text enhancer
    assert sorted(c.shape[1] for c in by["csp"]) == sorted([224, 112, 56, 28, 14] + [112, 56, 28, 14, 7])
    (nms,) = by["nms"]
    assert nms.shape == (64, 2000 * 4 + 1400 + 700, 100)
    train = work.step_calls(cfg, 64, train=True)
    assert sum(c.entry.endswith("_backward") for c in train) == len(calls) - 1


def test_step_calls_take_the_nms_cap():
    cfg = copy.deepcopy(spec.cell(spec.benchmark(), "eval_fp32_b64")["config_file"]["config"])
    cfg["tpu"]["nms_max_candidates"] = 2000
    (nms,) = [c for c in work.step_calls(cfg, 64, train=False) if c.entry == "nms"]
    assert nms.shape == (64, 2000, 100)


@pytest.mark.parametrize("path", ["dependency", "whole_block_stem", "hard_nms"])
def test_step_calls_refuse_what_they_do_not_count(monkeypatch, path):
    cfg = copy.deepcopy(spec.cell(spec.benchmark(), "eval_fp32_b64")["config_file"]["config"])
    if path == "dependency":
        cfg["model"]["use_dependency"] = True
    elif path == "whole_block_stem":
        monkeypatch.setenv("UNAV_FUSED_TBLOCK", "always")
    else:
        cfg["test_cfg"]["nms_method"] = "hard"
    with pytest.raises(NotImplementedError):
        work.step_calls(cfg, 64, train=False)


def test_least_time_is_the_larger_bound():
    call = work.Call("csp", (128, 224, CIN, MID, NG, FG, C, 8), "float32", 1)
    flops, nbytes = work.work(call)
    assert work.least_seconds(call) == max(flops / 495e12, nbytes / 3.35e12)
    assert flops / 495e12 > nbytes / 3.35e12                 # bound by its products
    nms = work.Call("nms", (64, 10100, 100), "float32", 1)
    assert work.work(nms)[0] == 0 and work.least_seconds(nms) == work.work(nms)[1] / 3.35e12
