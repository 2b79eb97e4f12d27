"""tools/bench.py on the CPU at a tiny width prints one JSON line with the
root bench.py's keys, the median of at least 5 windows for eval and for
train (its numbers there are not the card's)."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_prints_one_json_line():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-m", "unav_yolyolva_tpu_torch.tools.bench",
                          "--device", "cpu", "--tiny", "--iters", "1", "--commit", "abc"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.strip().splitlines()
    rec = json.loads(lines[-1])
    assert not any(line.startswith("{") for line in lines[:-1])
    assert rec["metric"] == "eval_videos_per_sec" and rec["unit"] == "videos/s"
    for key in ("value", "spread_pct", "windows", "busy_share", "peak_memory_gib",
                "train_clips_per_sec", "train_spread_pct", "train_windows", "device",
                "nvidia_smi", "commit", "protocol", "batch", "dtype"):
        assert key in rec, key
    for value, windows in ((rec["value"], rec["windows"]),
                           (rec["train_clips_per_sec"], rec["train_windows"])):
        assert len(windows) >= 5 and all(w > 0 for w in windows)
        assert value == sorted(windows)[len(windows) // 2]
    assert rec["device"] == "cpu" and rec["commit"] and rec["tiny"] is True
    assert rec["busy_share"] is None and rec["nvidia_smi"] is None


def test_bench_refuses_fewer_than_five_windows():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-m", "unav_yolyolva_tpu_torch.tools.bench",
                          "--device", "cpu", "--tiny", "--windows", "3"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and "at least 5" in res.stderr


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
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-m", "unav_yolyolva_tpu_torch.tools.bench",
                          "--device", "cpu", "--tiny", "--iters", "1",
                          "--compute-dtype", "bfloat16", "--commit", "abc"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec["dtype"] == "bfloat16" and rec["value"] > 0 and len(rec["windows"]) >= 5
    assert rec["train_dtype"] == "bfloat16" and rec["train_clips_per_sec"] > 0
    assert len(rec["train_windows"]) >= 5
