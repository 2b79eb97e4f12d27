"""The program's spans (utils/profiling.py): the off path, the spans of a
tiny train and eval step and their nesting, the kernel wrappers' spans
against the benchmark's count of a step's kernel calls, the bits left
unchanged by recording, the recorder's self time, and the benchmark's
reading of the spans from a trace (portbench/spans.py) on hand-made events.

`gpu`: the backward wrappers' spans of a bf16 train step on the card (the
CPU's fp32 step differentiates the plain forwards and calls no backward
wrapper)."""

from __future__ import annotations

import json
import os
import sys
import threading
from types import SimpleNamespace

import pytest
import torch

from _torch_port_common import one_torch_thread  # noqa: F401
from unav_yolyolva_tpu_torch.utils import profiling
from unav_yolyolva_tpu_torch.utils.profiling import record_spans, span

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "portbench", "tests"))

from _portbench_common import TINY  # noqa: E402  (puts the repository on the path)
from portbench import spans as bench_spans  # noqa: E402
from portbench import work  # noqa: E402
from portbench.run import _deep_update  # noqa: E402

BATCH = 2
PHASES = {"unav.train.forward", "unav.train.backward", "unav.train.update"}
MODEL = {"unav.model.alignment", "unav.model.backbone", "unav.model.heads"}


def _cfg(name="unav100_fp32", tiny=True):
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        cfg = json.load(f)["config"]
    return _deep_update(cfg, TINY) if tiny else cfg


def _train(cfg, device="cpu"):
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.train import (create_train_state, make_optimizer,
                                               make_train_step)

    model = build_model(cfg, device=device, seed=0)
    optimizer, _ = make_optimizer(model, cfg["opt"], 10, cfg["train_cfg"]["clip_grad_l2norm"])
    state = create_train_state(model, optimizer, cfg["train_cfg"]["init_loss_norm"])
    return state, make_train_step(model, optimizer, cfg, device=device)


def _train_batch(cfg):
    from unav_yolyolva_tpu_torch.data.synthetic import synthetic_train_batch

    m = cfg["model"]
    return synthetic_train_batch(torch.Generator().manual_seed(3), BATCH, m["max_seq_len"],
                                 m["raw_input_dim_V"], m["raw_input_dim_A"], m["num_classes"],
                                 cfg["dataset"]["max_num_events"])


def _eval(cfg):
    from unav_yolyolva_tpu_torch.data.synthetic import synthetic_eval_batch
    from unav_yolyolva_tpu_torch.eval.step import make_eval_step
    from unav_yolyolva_tpu_torch.models import build_model

    m = cfg["model"]
    batch = synthetic_eval_batch(torch.Generator().manual_seed(4), BATCH, m["max_seq_len"],
                                 m["raw_input_dim_V"], m["raw_input_dim_A"])
    return make_eval_step(build_model(cfg, device="cpu", seed=0), cfg, device="cpu"), batch


def _counts(rec):
    return {k: v["count"] for k, v in rec.summary().items()}


def _parents(rec):
    out = {}
    for name, parent, _, _ in rec.spans():
        out.setdefault(name, set()).add(parent)
    return out


def _forward_calls(cfg):
    calls = {}
    for c in work.step_calls(cfg, BATCH, train=False):
        calls[c.entry] = calls.get(c.entry, 0) + c.count
    return calls


def test_span_off_is_one_shared_noop():
    assert profiling._recorder is None
    a, b = span("unav.test.a"), span("unav.test.b")
    assert a is b
    with a as entered:
        assert entered is a


def test_steps_off_open_no_span(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span was made with tracing off")

    monkeypatch.setattr(profiling, "_Span", refuse)
    cfg = _cfg()
    state, step = _train(cfg)
    losses = step(state, _train_batch(cfg), 0)
    assert torch.isfinite(losses["final_loss"])
    eval_step, batch = _eval(cfg)
    from unav_yolyolva_tpu_torch.eval.step import fetch_detections

    dets, done = fetch_detections(eval_step(batch))
    assert done is None and dets["valid"].shape[0] == BATCH


def test_train_step_spans():
    cfg = _cfg()
    state, step = _train(cfg)
    with record_spans() as rec:
        step(state, _train_batch(cfg), 0)
    counts, parents = _counts(rec), _parents(rec)
    assert counts["unav.train.step"] == 1 and parents["unav.train.step"] == {None}
    for name in PHASES:
        assert counts[name] == 1 and parents[name] == {"unav.train.step"}, name
    for name in MODEL:
        assert counts[name] == 1 and parents[name] == {"unav.train.forward"}, name
    calls = _forward_calls(cfg)
    assert counts["unav.kernel.mhca"] == calls["mhca"]
    assert counts["unav.kernel.csp"] == calls["csp"]
    assert parents["unav.kernel.csp"] == {"unav.model.backbone"}
    assert "unav.kernel.nms" not in counts
    s = rec.summary()
    phases = sum(s[n]["total_ns"] for n in PHASES)
    assert phases <= s["unav.train.step"]["total_ns"]
    assert s["unav.train.step"]["self_ns"] == s["unav.train.step"]["total_ns"] - phases


def test_eval_step_spans():
    from unav_yolyolva_tpu_torch.eval.step import fetch_detections

    cfg = _cfg()
    eval_step, batch = _eval(cfg)
    with record_spans() as rec:
        fetch_detections(eval_step(batch))
    counts, parents = _counts(rec), _parents(rec)
    assert counts["unav.eval.step"] == 1 and parents["unav.eval.step"] == {None}
    for name in ("unav.eval.forward", "unav.eval.postprocess"):
        assert counts[name] == 1 and parents[name] == {"unav.eval.step"}, name
    assert counts["unav.eval.fetch"] == 1 and parents["unav.eval.fetch"] == {None}
    for name in MODEL:
        assert counts[name] == 1 and parents[name] == {"unav.eval.forward"}, name
    calls = _forward_calls(cfg)
    for entry in ("mhca", "csp", "nms"):
        assert counts[f"unav.kernel.{entry}"] == calls[entry], entry
    assert parents["unav.kernel.nms"] == {"unav.eval.postprocess"}
    assert parents["unav.kernel.mhca"] == {"unav.model.backbone"}


DEPENDENCY = {"unav.dependency.expand", "unav.dependency.temporal", "unav.dependency.cooccur",
              "unav.dependency.squeeze"}


@pytest.mark.parametrize("use_dependency", [True, False])
def test_dependency_block_spans(use_dependency):
    """With the block on, an eval step opens `unav.model.dependency` once, a
    sibling of `unav.model.backbone` under `unav.eval.forward`, and inside it
    each `unav.dependency.*` span once per pyramid level, the block's MHCA
    calls inside the two branches; with the block off, none of them."""
    from unav_yolyolva_tpu_torch.eval.step import fetch_detections

    cfg = _cfg("unav100_dep" if use_dependency else "unav100_fp32")
    assert cfg["model"]["use_dependency"] is use_dependency
    eval_step, batch = _eval(cfg)
    with record_spans() as rec:
        fetch_detections(eval_step(batch))
    counts, parents = _counts(rec), _parents(rec)
    levels = cfg["model"]["backbone_arch"][2] + 1
    for name in MODEL:
        assert counts[name] == 1 and parents[name] == {"unav.eval.forward"}, name
    if not use_dependency:
        assert not ({"unav.model.dependency"} | DEPENDENCY) & set(counts)
        return
    assert counts["unav.model.dependency"] == 1
    assert parents["unav.model.dependency"] == {"unav.eval.forward"}
    for name in DEPENDENCY:
        assert counts[name] == levels and parents[name] == {"unav.model.dependency"}, name
    mhca = [p for n, p, _, _ in rec.spans() if n == "unav.kernel.mhca"]
    assert mhca.count("unav.dependency.temporal") == mhca.count("unav.dependency.cooccur") \
        == levels
    assert len(mhca) == _forward_calls(dict(cfg, model=dict(cfg["model"], use_dependency=False))
                                       )["mhca"] + 2 * levels


def test_recording_leaves_the_train_step_bits():
    cfg = _cfg()
    batch = _train_batch(cfg)
    (s_off, step_off), (s_on, step_on) = _train(cfg), _train(cfg)
    off = step_off(s_off, batch, 7)
    with record_spans():
        on = step_on(s_on, batch, 7)
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k
    for (name, p), (_, q) in zip(s_off.model.named_parameters(), s_on.model.named_parameters()):
        assert torch.equal(p, q), name
    for (name, p), (_, q) in zip(s_off.ema.named_parameters(), s_on.ema.named_parameters()):
        assert torch.equal(p, q), name


def test_recording_leaves_the_detections_bits():
    cfg = _cfg()
    eval_step, batch = _eval(cfg)
    off = eval_step(batch)
    with record_spans():
        on = eval_step(batch)
    for k in off:
        assert torch.equal(off[k], on[k]), k


def test_summary_self_time():
    clock = iter([0, 10, 30, 40, 45, 70, 80, 100, 200, 230])
    with record_spans() as rec:
        rec.clock = lambda: next(clock)
        with span("unav.t.outer"):             # 0 .. 100
            with span("unav.t.a"):             # 10 .. 30
                pass
            with span("unav.t.b"):             # 40 .. 80
                with span("unav.t.a"):         # 45 .. 70
                    pass
        with span("unav.t.b"):                 # 200 .. 230
            pass
    s = rec.summary()
    assert s["unav.t.outer"] == {"count": 1, "total_ns": 100, "self_ns": 100 - 20 - 40}
    assert s["unav.t.a"] == {"count": 2, "total_ns": 20 + 25, "self_ns": 45}
    assert s["unav.t.b"] == {"count": 2, "total_ns": 40 + 30, "self_ns": 15 + 30}
    assert ("unav.t.a", "unav.t.b", 45, 70) in rec.spans()
    assert span("unav.t.x") is span("unav.t.y")           # off again after the region


def test_spans_on_another_thread_and_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    with record_spans() as rec:
        def worker():
            with span("unav.t.worker"):
                pass

        t = threading.Thread(target=worker)
        with span("unav.t.main"):
            t.start()
            t.join()
    assert {(n, p) for n, p, _, _ in rec.spans()} == {("unav.t.worker", None),
                                                       ("unav.t.main", None)}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("unav.t.traced"):
            torch.ones(4).sum()
    assert "unav.t.traced" in {e.name for e in prof.events()}


def test_span_annotations_are_not_kernels():
    """A span's annotation on the device's timeline is neither a kernel to
    the launch counts (key_averages rows) nor busy time to the bench."""
    from unav_yolyolva_tpu_torch.utils.profiling import busy_and_overlap, is_kernel

    def ev(name, a, b, dev="CUDA"):
        return SimpleNamespace(name=name, device_type=SimpleNamespace(name=dev),
                               time_range=SimpleNamespace(start=a, end=b))

    events = [ev("gemm_tc_kernel", 0, 10), ev("unav.kernel.csp", 0, 40),
              ev("unav.kernel.csp", 0, 40, "CPU"), ev("Memset (Device)", 30, 40)]
    assert [is_kernel(e) for e in events] == [True, False, False, False]
    row = SimpleNamespace(key="unav.eval.step", device_type=SimpleNamespace(name="CUDA"))
    assert not is_kernel(row)
    busy, _, _ = busy_and_overlap(SimpleNamespace(events=lambda: events), 40e-6)
    assert busy == 10 / 40


# portbench/spans.py on hand-made events: times in microseconds, as the
# profiler gives them

WINDOW = "portbench.window"


def _ev(name, start, end, thread=1, device="CPU", id=0):
    return SimpleNamespace(name=name, thread=thread, id=id, is_user_annotation=False,
                           device_type=SimpleNamespace(name=device),
                           time_range=SimpleNamespace(start=start, end=end))


def _launch(kid, at, thread=1, start=None, end=None):
    """A kernel `kid` launched at `at` on `thread`, running start .. end."""
    return [_ev("cudaLaunchKernel", at, at + 1, thread, id=kid),
            _ev(f"kernel_{kid}", start, end, 0, "CUDA", id=kid)]


def test_bench_spans_kernel_launched_on_another_thread():
    events = [_ev(WINDOW, 0, 100), _ev("unav.train.step", 1, 90),
              _ev("unav.train.backward", 40, 80),
              _ev("unav.kernel.mhca_backward", 50, 60, thread=2),
              *_launch(7, 52, thread=2, start=55, end=58),     # inside the wrapper's span
              *_launch(8, 62, thread=2, start=64, end=66)]     # cuBLAS, no span on thread 2
    r = bench_spans.reduce_events(events, WINDOW)
    assert r["device_s"]["unav.kernel.mhca_backward"] == pytest.approx(3e-6)
    assert r["device_s"]["unav.train.backward"] == pytest.approx(5e-6)
    assert r["device_s"]["unav.train.step"] == pytest.approx(5e-6)
    assert r["launches"] == {"unav.kernel.mhca_backward": 1, "unav.train.backward": 2,
                             "unav.train.step": 2}
    assert r["attributed_s"] == r["kernel_s"] == pytest.approx(5e-6)


def test_bench_spans_nested_and_queued():
    events = [_ev(WINDOW, 0, 100), _ev("unav.eval.step", 0, 50),
              _ev("unav.eval.forward", 1, 30), _ev("unav.model.backbone", 5, 25),
              _ev("unav.kernel.csp", 10, 12), _ev("unav.eval.postprocess", 31, 49),
              *_launch(1, 10.5, start=20, end=40),     # runs long after its launch
              *_launch(2, 14, start=40, end=45),       # the backbone's own kernel
              *_launch(3, 32, start=45, end=60),       # postprocess
              *_launch(4, 0.5, start=60, end=61)]      # in the step, in no phase
    r = bench_spans.reduce_events(events, WINDOW)
    d = {k: round(v * 1e6, 6) for k, v in r["device_s"].items()}
    assert d == {"unav.kernel.csp": 20, "unav.model.backbone": 25, "unav.eval.forward": 25,
                 "unav.eval.postprocess": 15, "unav.eval.step": 41}
    assert r["count"]["unav.eval.step"] == 1 and r["busy_s"] == pytest.approx(41e-6)


def test_bench_spans_idle_split_between_phases():
    events = [_ev(WINDOW, 0, 100), _ev("unav.train.step", 0, 100),
              _ev("unav.train.forward", 0, 50), _ev("unav.train.backward", 50, 100),
              *_launch(1, 1, start=10, end=20), *_launch(2, 30, start=40, end=60),
              *_launch(3, 70, start=90, end=100)]
    r = bench_spans.reduce_events(events, WINDOW)
    idle = {k: round(v * 1e6, 6) for k, v in r["idle_s"].items()}
    assert idle == {"unav.train.step": 60, "unav.train.forward": 30,
                    "unav.train.backward": 30}
    assert r["window_s"] == pytest.approx(100e-6) and r["busy_s"] == pytest.approx(40e-6)


def test_bench_spans_unattributed_and_outside():
    events = [_ev(WINDOW, 10, 100), _ev("unav.eval.step", 20, 30),
              _ev("unav.eval.step", 0, 5),                       # before the window
              *_launch(1, 22, start=25, end=35),
              *_launch(2, 40, start=40, end=50),                 # launched in no span
              _ev("kernel_3", 60, 70, 0, "CUDA", id=3),           # no launch recorded
              _ev("Memcpy HtoD", 70, 80, 0, "CUDA", id=4),        # not a kernel
              _ev("unav.eval.step", 26, 28, 0, "CUDA", id=1)]     # the span on the device
    r = bench_spans.reduce_events(events, WINDOW)
    assert r["count"] == {"unav.eval.step": 1}
    assert r["kernel_s"] == pytest.approx(30e-6) and r["attributed_s"] == pytest.approx(10e-6)
    assert r["launches"] == {"unav.eval.step": 1}
    assert bench_spans.reduce_events(events, "no.such.window") == {}


@pytest.mark.gpu
def test_backward_wrapper_spans_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    cfg = _cfg("unav100_bf16", tiny=False)         # the bf16 kernels at the published widths
    state, step = _train(cfg, device="cuda")
    batch = _train_batch(cfg)
    step(state, batch, 0)
    with record_spans() as rec:
        step(state, batch, 1)
    torch.cuda.synchronize()
    counts = _counts(rec)
    calls = {}
    for c in work.step_calls(cfg, BATCH, train=True):
        calls[c.entry] = calls.get(c.entry, 0) + c.count
    for entry in ("mhca", "csp", "mhca_backward", "csp_backward"):
        assert counts[f"unav.kernel.{entry}"] == calls[entry], entry
    assert counts["unav.train.backward"] == 1


@pytest.mark.gpu
def test_dependency_block_spans_on_the_card():
    """A served batch of 64 at the published widths with the dependency
    block under torch.profiler: the MHCA wrapper launches 17 times (the 5 of
    the model without the block and the block's 12, portbench's
    work_dependency count), the block's 12 calls open their spans inside
    `unav.dependency.temporal` and `.cooccur`, and each launches kernels
    that the trace attributes to `unav.model.dependency`."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    from torch.profiler import ProfilerActivity, profile

    from portbench import work_dependency
    from unav_yolyolva_tpu_torch.core import resolve_device
    from unav_yolyolva_tpu_torch.data.synthetic import synthetic_eval_batch
    from unav_yolyolva_tpu_torch.eval.step import fetch_detections, make_eval_step
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.ops.fused_mhca import fused_mhca

    dev = resolve_device("cuda")
    cfg = _cfg("unav100_dep", tiny=False)
    m = cfg["model"]
    step = make_eval_step(build_model(cfg, device=dev, seed=0), cfg, dev)
    batch = synthetic_eval_batch(torch.Generator().manual_seed(5), 64, m["max_seq_len"],
                                 m["raw_input_dim_V"], m["raw_input_dim_A"])
    fetch_detections(step(batch))
    torch.cuda.synchronize()
    before = fused_mhca.launches
    with record_spans() as rec, profile(activities=[ProfilerActivity.CPU,
                                                    ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            _, done = fetch_detections(step(batch))
            done.synchronize()
            torch.cuda.synchronize()
    calls = work_dependency.step_calls(cfg, 64, train=False)
    block = work_dependency.block_calls(cfg, 64)
    assert fused_mhca.launches - before == sum(c.count for c in calls if c.entry == "mhca") == 17
    assert len(block) == 12
    mhca_parents = [p for n, p, _, _ in rec.spans() if n == "unav.kernel.mhca"]
    assert mhca_parents.count("unav.dependency.temporal") == 6
    assert mhca_parents.count("unav.dependency.cooccur") == 6
    events = list(prof.events())
    dep = [e for e in events if e.name == "unav.model.dependency" and e.device_type.name == "CPU"]
    assert len(dep) == 1
    d0, d1 = dep[0].time_range.start, dep[0].time_range.end
    inner = [e for e in events if e.name == "unav.kernel.mhca" and e.device_type.name == "CPU"
             and d0 <= e.time_range.start and e.time_range.end <= d1]
    kernel_ids = {e.id for e in events if bench_spans._is_kernel(e)}
    launches = [e for e in events if e.device_type.name == "CPU" and e.id in kernel_ids
                and e.name.startswith(bench_spans.LAUNCH_PREFIX)]
    assert len(inner) == 12
    for s in inner:
        assert any(s.time_range.start <= x.time_range.start <= s.time_range.end
                   for x in launches), "a block MHCA call launched no kernel"
    r = bench_spans.reduce(prof, WINDOW)
    assert r["count"]["unav.kernel.mhca"] == 17 and r["count"]["unav.model.dependency"] == 1
    assert r["device_s"]["unav.model.dependency"] > 0
    for name in ("expand", "temporal", "cooccur", "squeeze"):
        assert r["count"][f"unav.dependency.{name}"] == 6, name
