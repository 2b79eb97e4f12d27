"""One run of one cell of BENCHMARK.json on the card this process finds.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix and metrics are found by name
(portbench/spec.py); the mix's `kind` names the module that runs it
(portbench/modes/<kind>.py), which sets up, measures for --seconds and
checks what the window produced against the reference. With --trace 0 the
line carries the cell's end-to-end metrics, with --trace 1 its per-layer
metrics, each read by portbench/metrics/<name>.py from the run's record.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and with --trace 1 breakdown), then `checks`, each
compared number beside its limit, which the last lines of standard error
repeat. A run exits non-zero and prints no result where the card is missing
or there are fewer cards than the cell asks for, where the program is not
in the checkout, and where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "unav_yolyolva_tpu")
PROGRAM = "unav_yolyolva_tpu_torch"


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _deep_update(dst, src):
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_update(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device=None,
             overrides=None, mix_overrides=None, judge_overrides=None):
    """(exit code, result line or None) of one run. `device` None asks for
    the cards the cell needs; the tests pass device="cpu" with tiny
    `overrides` of the configuration, the mix and the comparison's settings
    (they skip the look for a card)."""
    import torch

    from . import common, spec

    t_start = common.process_start() if device is None else time.time()
    bench = spec.benchmark()
    w = spec.cell(bench, workload)
    if importlib.util.find_spec(PROGRAM) is None:
        print(f"portbench: the program {PROGRAM} is not in this checkout", file=sys.stderr)
        return 2, None
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"portbench: {workload} needs {w['chips']} CUDA device(s); this process "
                  f"finds {n}", file=sys.stderr)
            return 2, None
        device = "cuda:0"
    dev = torch.device(device)
    cfg = _deep_update(copy.deepcopy(w["config_file"]["config"]), overrides or {})
    mix = _deep_update(copy.deepcopy(w["traffic_file"]), mix_overrides or {})
    from .check import judge, limits

    torch.set_num_threads(min(4, torch.get_num_threads()))
    ctx = {"cfg": cfg, "mix": mix, "seed": seed, "seconds": seconds, "trace": trace,
           "device": dev, "t_start": t_start, "config_file": w["config_file"],
           "judge": dict(judge(workload), **(judge_overrides or {}))}
    record = spec.mode(mix["kind"]).run(ctx)

    metrics = {}
    for m in (w["per_layer"] if trace else w["end_to_end"]):
        value = spec.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    lim = limits(workload)
    numbers = record["check"]
    checks = {k: {"value": numbers[k], "limit": lim[k]} for k in lim}
    correct = all(numbers[k] <= lim[k] for k in lim)
    device_block = dict(record["device"])
    line = {"correct": correct, "attempted": record["attempted"], "failed": record["failed"],
            "metrics": metrics, "device": device_block}
    if trace and record.get("trace"):
        t = record["trace"]
        device_block.update(busy_s=t["busy_s"], window_s=t["window_s"])
        line["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    line["checks"] = checks

    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3, None
    if dev.type == "cuda":
        print(f"card: {common.power_limit()}", file=sys.stderr)
    print("also read: " + json.dumps({k: v for k, v in numbers.items() if k not in lim}),
          file=sys.stderr)
    print(f"correct: {correct}; each compared number beside its limit:", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    return 0, line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One run of one cell of BENCHMARK.json.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number at least 0")
    rc, line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    if line is not None:
        sys.stdout.flush()
        print(json.dumps(line), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
