"""tools/bench.py on the CPU at a tiny width prints one JSON line with the
root bench.py's keys, the median of at least 5 windows for eval and for
train (its numbers there are not the card's), and honours the root bench's
knobs; tools/flops.py counts the model's FLOPs the same whatever runs a
layer, and the same as the products and convolutions of the JAX package's
model."""

import json
import math
import os
import subprocess
import sys

import pytest

from unav_yolyolva_tpu_torch.tools.bench import BASELINE, load_protocol
from unav_yolyolva_tpu_torch.tools.flops import model_flops
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one thread a bench process: the tests run beside others, and torch's
# default of a thread a core oversubscribes the machine
ENV = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
EVAL, TRAIN = "avel_unav100_eval.yaml", "avel_unav100.yaml"


def bench(*args, timeout=600):
    return subprocess.run([sys.executable, "-m", "unav_yolyolva_tpu_torch.tools.bench",
                           "--device", "cpu", "--tiny", *args],
                          cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def tiny_flops():
    """model_flops at the tiny width, counted once for the module:
    {(protocol, batch, train): FLOPs}."""
    return {(name, b, train): model_flops(load_protocol(name, True), b, train)
            for name, b, train in ((EVAL, 2, False), (EVAL, 4, False), (TRAIN, 2, True))}


def test_bench_prints_one_json_line(tiny_flops):
    res = bench("--iters", "1", "--commit", "abc", "--eval-batch", "4", "--train-batch", "2",
                "--compute-dtype", "bfloat16", "--train-dtype", "float32",
                "--nms-candidates", "50")
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.strip().splitlines()
    rec = json.loads(lines[-1])
    assert not any(line.startswith("{") for line in lines[:-1])
    assert rec["metric"] == "eval_videos_per_sec" and rec["unit"] == "videos/s"
    for key in ("value", "spread_pct", "windows", "busy_share", "peak_memory_gib",
                "train_clips_per_sec", "train_spread_pct", "train_windows", "device",
                "nvidia_smi", "commit", "protocol", "batch", "dtype", "vs_baseline",
                "flops_per_video", "flops_unit", "mfu_vs_bf16_peak", "train_flops_per_clip",
                "train_mfu_vs_bf16_peak", "nms_candidates"):
        assert key in rec, key
    for value, windows in ((rec["value"], rec["windows"]),
                           (rec["train_clips_per_sec"], rec["train_windows"])):
        assert len(windows) >= 5 and all(w > 0 for w in windows)
        assert value == sorted(windows)[len(windows) // 2]
    assert rec["device"] == "cpu" and rec["commit"] and rec["tiny"] is True
    assert rec["busy_share"] is None and rec["nvidia_smi"] is None
    # the knobs: eval at 4 videos in bf16 with the candidate cap, train at 2 clips in fp32
    assert rec["batch"] == 4 and rec["dtype"] == "bfloat16" and rec["nms_candidates"] == 50
    assert rec["train_batch"] == 2 and rec["train_dtype"] == "float32"
    # the FLOP counts are tools/flops.py's, per video and per clip; no peak on the CPU
    assert rec["flops_unit"] == "GFLOP"
    assert rec["flops_per_video"] == tiny_flops[EVAL, 4, False] / 4 / 1e9
    assert rec["train_flops_per_clip"] == tiny_flops[TRAIN, 2, True] / 2 / 1e9
    assert rec["mfu_vs_bf16_peak"] is None and rec["train_mfu_vs_bf16_peak"] is None
    with open(BASELINE) as f:
        base = json.load(f)["pytorch_cpu_eval_videos_per_sec"]
    assert rec["vs_baseline"] == rec["value"] / base


def test_bench_refuses_fewer_than_five_windows():
    res = bench("--windows", "3", timeout=300)
    assert res.returncode != 0 and "at least 5" in res.stderr


@pytest.mark.parametrize("flag,value", [("--eval-batch", "0"), ("--train-batch", "0"),
                                        ("--nms-candidates", "-1")])
def test_bench_refuses_an_empty_batch_or_a_negative_cap(flag, value):
    res = bench(flag, value, timeout=300)
    assert res.returncode != 0 and "must be positive" in res.stderr


def test_busy_share_and_copy_overlap_of_a_trace():
    """The bench's busy share is the union of the kernels' intervals over
    the wall time; the copy overlap is the share of the host-to-device copy
    time spent under a kernel."""
    from types import SimpleNamespace as NS

    from unav_yolyolva_tpu_torch.utils.profiling import busy_and_overlap

    def ev(name, a, b, dev="CUDA"):
        return NS(name=name, device_type=NS(name=dev), time_range=NS(start=a, end=b))

    prof = NS(events=lambda: [ev("gemm_tc_kernel", 0, 10), ev("nms", 5, 15),
                              ev("csp", 20, 30), ev("Memcpy HtoD (Pinned -> Device)", 8, 12),
                              ev("Memcpy HtoD (Pinned -> Device)", 16, 18),
                              ev("Memset (Device)", 30, 40), ev("aten::add", 0, 40, "CPU")])
    busy, copy_ms, under = busy_and_overlap(prof, 40e-6)
    assert busy == 25 / 40 and copy_ms == 6e-3 and under == 4 / 6


def test_bench_serves_at_bf16():
    """--compute-dtype bfloat16 serves the eval half and trains the train
    half at the bf16 policy, and says so."""
    res = bench("--iters", "1", "--compute-dtype", "bfloat16", "--commit", "abc")
    assert res.returncode == 0, res.stdout + res.stderr
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec["dtype"] == "bfloat16" and rec["value"] > 0 and len(rec["windows"]) >= 5
    assert rec["train_dtype"] == "bfloat16" and rec["train_clips_per_sec"] > 0
    assert len(rec["train_windows"]) >= 5


# tools/flops.py at the protocols' full width (fake tensors, no arithmetic):
# pinned, so that a change that moves the yardstick shows here
EVAL_GFLOP_PER_VIDEO = 28.70
TRAIN_GFLOP_PER_CLIP = 85.66


def test_model_flops_at_the_eval_protocol():
    cfg = load_protocol(EVAL, False)
    per_video = model_flops(cfg, cfg["loader"]["batch_size"]) / cfg["loader"]["batch_size"]
    assert per_video / 1e9 == pytest.approx(EVAL_GFLOP_PER_VIDEO, rel=1e-3)


def test_model_flops_at_the_train_protocol():
    cfg = load_protocol(TRAIN, False)
    per_clip = model_flops(cfg, cfg["loader"]["batch_size"], True) / cfg["loader"]["batch_size"]
    assert per_clip / 1e9 == pytest.approx(TRAIN_GFLOP_PER_CLIP, rel=1e-3)


@pytest.mark.parametrize("train", [False, True])
def test_model_flops_ignore_the_stem_route(train, tiny_flops, monkeypatch):
    """The whole-block stem (a kernel on the card, its plain version here)
    does not move the count, and counting leaves the route as it was."""
    from unav_yolyolva_tpu_torch.models import blocks

    name = TRAIN if train else EVAL
    monkeypatch.setenv("UNAV_FUSED_TBLOCK", "always")
    monkeypatch.setattr(blocks, "FUSED_TBLOCK", "always")
    assert model_flops(load_protocol(name, True), 2, train) == tiny_flops[name, 2, train] > 0
    assert os.environ["UNAV_FUSED_TBLOCK"] == "always" and blocks.FUSED_TBLOCK == "always"


def test_model_flops_are_linear_in_the_eval_batch(tiny_flops):
    assert tiny_flops[EVAL, 4, False] == 2 * tiny_flops[EVAL, 2, False] > 0


def _jax_products(jaxpr) -> int:
    """2 x M x N x K over the dot_general and conv_general_dilated equations
    of a jaxpr and of the jaxprs inside them (a scan's times its length),
    with tools/flops.py's rules: a vector product (K = 1, or M = N = 1)
    counts nothing, and a convolution with an input dilation (the input's
    gradient of a strided one) counts over its undilated input, as a
    transposed convolution does."""
    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        assert name not in ("pallas_call", "while", "cond"), name
        shapes = [v.aval.shape for v in eqn.invars]
        out = eqn.outvars[0].aval.shape
        if name == "dot_general":
            (lc, rc), (lb, rb) = eqn.params["dimension_numbers"]
            k = math.prod(shapes[0][d] for d in lc)
            m = math.prod(n for d, n in enumerate(shapes[0]) if d not in lc + lb)
            n = math.prod(n for d, n in enumerate(shapes[1]) if d not in rc + rb)
            total += 2 * math.prod(out) * k if k > 1 and m * n > 1 else 0
        elif name == "conv_general_dilated":
            (lhs, rhs), dn = shapes, eqn.params["dimension_numbers"]
            if any(d > 1 for d in eqn.params["lhs_dilation"]):
                total += 2 * lhs[dn.lhs_spec[0]] * math.prod(
                    lhs[d] for d in dn.lhs_spec[2:]) * math.prod(rhs)
            else:
                total += 2 * math.prod(out) * math.prod(rhs[d] for d in dn.rhs_spec[1:])
        for value in eqn.params.values():
            for sub in value if isinstance(value, (tuple, list)) else (value,):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    total += eqn.params.get("length", 1) * _jax_products(sub)
    return total


def _jax_model_flops(name: str, batch: int, train: bool) -> int:
    """The JAX package's model at the tiny protocol `name`, traced at fp32
    (no arithmetic runs): the eval forward's products, or the train step's
    forward, losses and parameter gradient, the targets made outside."""
    import jax
    import jax.numpy as jnp
    import yaml
    from jax._src.interpreters import partial_eval as pe

    from unav_yolyolva_tpu.core.config import load_config_dict
    from unav_yolyolva_tpu.geometry.points import concat_points, generate_points
    from unav_yolyolva_tpu.models import build_model
    from unav_yolyolva_tpu.models.meta_arch import compute_losses
    from unav_yolyolva_tpu.train.step import _loss_kwargs, build_targets
    from unav_yolyolva_tpu_torch.tools.bench import TINY, _deep_update

    with open(os.path.join(ROOT, "configs", name)) as f:
        cfg = load_config_dict(_deep_update(yaml.safe_load(f), TINY))
    cfg["tpu"]["compute_dtype"] = "float32"
    m, t = cfg["model"], cfg["model"]["max_seq_len"]
    n = cfg["dataset"]["max_num_events"]
    model = build_model(cfg)
    batch_in = {"visual": jnp.zeros((batch, t, m["raw_input_dim_V"])),
                "audio": jnp.zeros((batch, t, m["raw_input_dim_A"])),
                "mask": jnp.ones((batch, t), bool), "gt_segments": jnp.zeros((batch, n, 2)),
                "gt_labels": jnp.zeros((batch, n), jnp.int32),
                "gt_valid": jnp.zeros((batch, n), bool)}
    points = jnp.asarray(concat_points(generate_points(t, m["regression_range"],
                                                       m["scale_factor"])))
    m_scores, m_start_end, m_labels, gt_cls, gt_reg = build_targets(
        batch_in, points, t, m["num_classes"], m["class_aware"])
    inputs = {"visual": batch_in["visual"], "audio": batch_in["audio"],
              "mask": batch_in["mask"], "m_scores": m_scores, "m_start_end": m_start_end,
              "m_labels": m_labels}
    key = jax.random.PRNGKey(0)
    params = jax.eval_shape(lambda: model.init({"params": key, "droppath": key}, inputs))

    def forward(p, x):
        out = model.apply(p, x, train=False)
        return out["cls_logits"], out["offsets"], out["masks"]

    def gradient(p, x):
        def loss(q):
            out = model.apply(q, x, train=True, rngs={"droppath": key})
            losses, _ = compute_losses(out, gt_cls, gt_reg, jnp.float32(100.0),
                                       **_loss_kwargs(cfg))
            return losses["final_loss"]
        return jax.grad(loss)(p)

    jaxpr = jax.make_jaxpr(gradient if train else forward)(params, inputs).jaxpr
    jaxpr, _ = pe.dce_jaxpr(jaxpr, [True] * len(jaxpr.outvars))
    return _jax_products(jaxpr)


@pytest.mark.parametrize("train", [False, True])
def test_model_flops_match_the_jax_model(train, tiny_flops, monkeypatch):
    """The same count as the products and convolutions of the JAX package's
    model at the same tiny configuration and batch, exactly: a product the
    port's counter missed (an attention written as a multiply and a sum) or
    counted twice would show here. The JAX heads run per level
    (UNAV_PACKED_HEADS=never), as the port's do: the packed form also runs
    them on the zero frames between the levels."""
    monkeypatch.setenv("UNAV_PACKED_HEADS", "never")
    name = TRAIN if train else EVAL
    assert tiny_flops[name, 2, train] == _jax_model_flops(name, 2, train) > 0


@pytest.mark.parametrize("case", ["depthwise_convolution", "vector_products"])
def test_counting_rules(case):
    """A grouped convolution's backward counts the forward's products once
    for the input and once for the weight; a dot or an outer product of
    vectors counts nothing, a matrix product 2 x M x N x K."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from unav_yolyolva_tpu_torch.tools.flops import _formulas

    counter = FlopCounterMode(display=False, custom_mapping=_formulas())
    if case == "depthwise_convolution":
        x = torch.zeros(2, 8, 16, requires_grad=True)
        w = torch.zeros(8, 1, 3, requires_grad=True)
        with counter:
            torch.nn.functional.conv1d(x, w, padding=1, groups=8).sum().backward()
        assert counter.get_total_flops() == 3 * (2 * 2 * 8 * 3 * 16)
    else:
        a, b = torch.zeros(5, 1, 4), torch.zeros(5, 4, 1)
        with counter:
            torch.bmm(a, b)                          # a dot a row
            torch.bmm(b, a)                          # an outer product a row
            torch.zeros(2, 3) @ torch.zeros(3, 4)    # 2 x 2 x 4 x 3
        assert counter.get_total_flops() == 48


def test_bench_counts_each_configuration_once(monkeypatch):
    """The bench counts a configuration's FLOPs once in a process, whatever
    its tpu.* settings (the count is fp32 and skips decode and NMS)."""
    from unav_yolyolva_tpu_torch.tools import bench as bench_mod
    from unav_yolyolva_tpu_torch.tools import flops

    calls = []
    monkeypatch.setattr(flops, "model_flops",
                        lambda cfg, b, train: calls.append((b, train)) or 7 * b)
    monkeypatch.setattr(bench_mod, "_FLOPS", {})
    cfg = load_protocol("avel_unav100.yaml", True)
    bf16 = load_protocol("avel_unav100.yaml", True)
    bf16["tpu"].update(compute_dtype="bfloat16", nms_max_candidates=50)
    assert bench_mod.counted_flops(cfg, 2, True) == 14
    assert bench_mod.counted_flops(bf16, 2, True) == 14
    assert bench_mod.counted_flops(cfg, 4, True) == 28
    assert bench_mod.counted_flops(cfg, 2, False) == 14
    assert calls == [(2, True), (4, True), (2, False)]
