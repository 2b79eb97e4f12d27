"""The harness itself: cells found by name, BENCHMARK.json's names and
units, the result line's keys, the refusals (no card, no program, JAX
loaded), and `correct` coming out false when the timed path is broken
underneath (driven on the CPU at a tiny width, past the look for a card)."""

import copy
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from _portbench_common import ROOT, TINY, TINY_MIX
from portbench import run, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}
ENV = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")


def _tiny(workload, seed=5, trace=False, dtype=None, **mix):
    over = copy.deepcopy(TINY)
    if dtype:
        over["tpu"] = {"compute_dtype": dtype}
    return run.run_cell(workload, seed, 1.0, trace, device="cpu", overrides=over,
                        mix_overrides=dict(TINY_MIX, **mix))


def _short(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_benchmark_names_and_units():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["portbench"] and all(_short(w) for w in b["command"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _short(c["source"]) and _short(c["why"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] == 1 and _short(w["why"])
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(names)) == len(names) and "setup_s" in names
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _short(m["layer"]) and m["moves"] in names
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics", m["name"] + ".py"))
    for w in b["workloads"]:
        cell = spec.cell(b, w["name"])
        assert [m["name"] for m in cell["end_to_end"]].count("setup_s") == 1
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in [e["name"] for e in cell["end_to_end"]]
        assert os.path.exists(os.path.join(ROOT, "portbench", "limits", w["name"] + ".json"))


def _hashes(top):
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, top)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_cell_added_as_files_is_found_by_name(tmp_path):
    """A later cell adds a configuration, a mix, its limits and an entry; the
    harness runs it by name, and no file that was there changes."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    before = _hashes(tmp_path / "portbench")
    pb = tmp_path / "portbench"
    conf = json.loads((pb / "configs" / "unav100_fp32.json").read_text())
    conf["name"] = "unav100_fp32_copy"
    (pb / "configs" / "unav100_fp32_copy.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "traffic" / "eval_b64.json").read_text())
    mix["min_len"] = 200
    (pb / "traffic" / "eval_long.json").write_text(json.dumps(mix))
    (pb / "limits" / "eval_long_b64.json").write_text(
        (pb / "limits" / "eval_fp32_b64.json").read_text())
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="unav100_fp32_copy",
                                 file="portbench/configs/unav100_fp32_copy.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="eval_long_b64",
                                   config="unav100_fp32_copy", traffic="eval_long"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "eval_fp32_b64" in m.get("workloads", []):
            m["workloads"].append("eval_long_b64")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = ("import json, sys; sys.path[:0] = [%r, %r]; from portbench import run; "
              "rc, line = run.run_cell('eval_long_b64', 9, 1.0, False, device='cpu', "
              "overrides=%r, mix_overrides=%r); print(json.dumps(line))"
              % (str(tmp_path), ROOT, TINY, dict(TINY_MIX, min_len=60)))
    res = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                         text=True, env=ENV, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and set(line["metrics"]) == {"videos_per_s", "eval_p95_ms",
                                                        "setup_s"}
    after = _hashes(tmp_path / "portbench")
    assert {k: after[k] for k in before} == before


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_carries_the_contract_keys(trace):
    rc, line = _tiny("eval_fp32_b64", trace=trace)
    assert rc == 0 and line["correct"] is True
    keys = list(line)
    assert keys[:5] == LINE_KEYS and keys[-1] == "checks"
    assert set(keys) == set(LINE_KEYS) | {"checks"} | ({"breakdown"} if trace else set())
    assert set(line["device"]) == DEVICE_KEYS | ({"busy_s", "window_s"} if trace else set())
    wanted = spec.cell(spec.benchmark(), "eval_fp32_b64")["per_layer" if trace else "end_to_end"]
    for name, m in line["metrics"].items():
        assert name in [w["name"] for w in wanted] and set(m) == {"value", "unit"}
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(line)


def test_no_card_no_result():
    res = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "eval_fp32_b64",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, env=ENV, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA" in res.stderr


def test_no_program_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    res = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "eval_fp32_b64",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, env=ENV, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_jax_loaded_is_found_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "unav_yolyolva_tpu_torch_like", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "unav_yolyolva_tpu.models", object())
    assert run.forbidden_modules() == ["unav_yolyolva_tpu.models"]


# ---- the timed path broken underneath: `correct` comes out false ----------

def _wrap_eval(monkeypatch, fault):
    from unav_yolyolva_tpu_torch.eval import step as step_mod

    real = step_mod.make_eval_step

    def make(*a, **k):
        inner = real(*a, **k)
        first = {}

        def broken(batch):
            dets = inner(batch)
            if fault == "stale":            # returns its first answer, whatever it is given
                first.setdefault("d", dets)
                return first["d"]
            dets = {n: v.clone() for n, v in dets.items()}
            if fault == "half_rows":        # half of the batch left out
                h = dets["valid"].shape[0] // 2
                for v in dets.values():
                    v[h:] = 0
            elif fault == "altered":        # one answer altered where it is produced
                dets["scores"][0, 0] *= 0.5
            return dets
        return broken
    monkeypatch.setattr(step_mod, "make_eval_step", make)


@pytest.mark.parametrize("fault", ["stale", "half_rows", "altered"])
def test_eval_fault_is_not_correct(monkeypatch, fault):
    _wrap_eval(monkeypatch, fault)
    rc, line = _tiny("eval_fp32_b64", seed=21)
    assert rc == 0 and line["correct"] is False


def test_a_padded_row_is_no_video():
    """A mix that pads the last row of each batch serves batch - 1 videos a
    batch, and the rate counts only those."""
    over = copy.deepcopy(TINY)
    rcs = {}
    for pad in (False, True):
        rc, line = run.run_cell("eval_fp32_b64", 5, 1.0, False, device="cpu", overrides=over,
                                mix_overrides=dict(TINY_MIX, pad_last=pad))
        assert rc == 0 and line["correct"]
        rcs[pad] = line["attempted"]
    per = TINY_MIX["batch"]
    assert rcs[False] % per == 0 and rcs[True] % (per - 1) == 0


def _wrap_train(monkeypatch, fault):
    from unav_yolyolva_tpu_torch import train as train_pkg

    real = train_pkg.make_train_step

    def make(model, optimizer, cfg, *a, **k):
        inner = real(model, optimizer, cfg, *a, **k)

        def broken(state, batch, seed=0):
            if fault == "ema_unchanged":    # the step leaves the EMA where it was
                with torch.no_grad():
                    saved = [e.detach().clone() for e in state.ema.parameters()]
                out = inner(state, batch, seed)
                with torch.no_grad():
                    for e, s in zip(state.ema.parameters(), saved):
                        e.copy_(s)
                return out
            if fault == "unchanged":        # a step that returns its state unchanged
                with torch.no_grad():
                    saved = [p.detach().clone() for p in state.model.parameters()]
                out = inner(state, batch, seed)
                with torch.no_grad():
                    for p, s in zip(state.model.parameters(), saved):
                        p.copy_(s)
                optimizer.inner.state.clear()
                return out
            h = batch["visual"].shape[0] // 2   # half the batch, the mean over the rest
            return inner(state, {n: v[:h] for n, v in batch.items()}, seed)
        return broken
    monkeypatch.setattr(train_pkg, "make_train_step", make)


@pytest.mark.parametrize("fault", [None, "unchanged", "ema_unchanged", "half_batch"])
def test_train_fault_is_not_correct(monkeypatch, fault):
    """At float32 (the tiny width's plain bf16 path reads wider gaps than the
    card's kernels at the full width), the sound run is correct and each
    fault is not."""
    if fault:
        _wrap_train(monkeypatch, fault)
    rc, line = _tiny("train_bf16_b64", seed=23, dtype="float32", warm=4)
    assert rc == 0 and line["correct"] is (fault is None)


@pytest.mark.gpu
def test_a_run_on_the_card(card):
    rc, line = run.run_cell("eval_fp32_b64", 31, 3.0, False)
    assert rc == 0 and line["correct"] and line["device"]["platform"] == "gpu"
