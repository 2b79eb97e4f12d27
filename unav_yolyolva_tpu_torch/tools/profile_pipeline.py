"""Where the time of serving from files goes on the card's host.

    python -m unav_yolyolva_tpu_torch.tools.profile_pipeline [--videos 512]
        [--workers 4 8] [--seed 0]

Writes --videos synthetic validation videos at the flagship width (2048-d
visual, 128-d audio, 48-224 frames, 100 classes) to a temporary directory
and builds the flagship model of configs/avel_unav100_eval.yaml (B=64,
random weights from --seed), then reports:
  * the cost of starting a process: `import torch` and `import` of the data
    workers' module (data/workers.py), each in a fresh interpreter;
  * reading one batch's 192 feature files with np.load and with
    data/dataset.py:read_npy, and UnAV100Dataset.load_item of 64 videos,
    in this process;
  * for each --workers count, the Batcher alone (pinned batches, no
    compute; three epochs of the same workers) and the Batcher feeding
    valid_one_epoch (two epochs): each batch's arrival at the loop in ms
    from the epoch's start, the epoch's videos/s and the videos/s after
    the first batch arrived, and the copier's mean ms per batch;
  * valid_one_epoch over the same batches already in pinned memory.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _fresh(code: str) -> float:
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=dict(os.environ, PYTHONPATH=ROOT))
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--videos", type=int, default=512)
    ap.add_argument("--workers", type=int, nargs="+", default=[4, 8])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..core import load_config, resolve_device
    from ..data import pipeline
    from ..data.dataset import UnAV100Dataset, read_npy
    from ..data.synthetic import make_synthetic_dataset
    from ..eval.step import make_eval_step
    from ..models import build_model
    from ..train.loop import valid_one_epoch

    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(f"host: {len(os.sched_getaffinity(0))} cores; card: {smi}", flush=True)
    print(f"fresh interpreter: import torch {_fresh('import torch'):.2f} s, import the data "
          f"workers' module {_fresh('import unav_yolyolva_tpu_torch.data.workers'):.2f} s",
          flush=True)

    with tempfile.TemporaryDirectory() as root:
        synth = make_synthetic_dataset(root, num_videos=args.videos, num_classes=100,
                                       min_len=48, max_len=224, val_fraction=1.0,
                                       seed=args.seed)
        cfg = load_config(os.path.join(ROOT, "configs", "avel_unav100_eval.yaml"))
        cfg["dataset"].update(json_file=synth["json_file"], feat_folder=synth["feat_folder"])
        ds = UnAV100Dataset(False, ["validation"], **cfg["dataset"])
        bsz = cfg["loader"]["batch_size"]
        paths = [ds._feat_path(r.id, k) for r in ds.records[:bsz]
                 for k in ("rgb", "flow", "vggish")]
        for name, fn in (("np.load", lambda: [np.load(p) for p in paths]),
                         ("read_npy", lambda: [read_npy(p) for p in paths]),
                         ("load_item", lambda: [ds.load_item(i) for i in range(bsz)])):
            fn()
            t0 = time.perf_counter()
            fn()
            print(f"one batch's files, {name}: {(time.perf_counter() - t0) * 1e3:.1f} ms "
                  f"({len(paths)} files, {bsz} videos)", flush=True)

        model = build_model(cfg, device=dev, seed=args.seed)
        step = make_eval_step(model, cfg, device=dev)
        out = os.path.join(root, "results.pkl")
        copy_ms = []
        copy_out = pipeline._Pool.copy_out

        def timed_copy_out(self, msg, empty):
            t0 = time.perf_counter()
            batch = copy_out(self, msg, empty)
            copy_ms.append((time.perf_counter() - t0) * 1e3)
            return batch

        pipeline._Pool.copy_out = timed_copy_out
        for nw in args.workers:
            with pipeline.Batcher(ds, bsz, shuffle=False, drop_last=False, num_workers=nw,
                                  max_div_factor=32, empty=pipeline.pinned_empty) as b:
                for mode, epochs in (("alone", 3), ("valid_one_epoch", 2)):
                    for _ in range(epochs):
                        arrivals, copy_ms[:] = [], []

                        class Stamped:
                            def __len__(self):
                                return len(b)

                            def __iter__(self):
                                for x in b:
                                    arrivals.append(time.perf_counter())
                                    yield x

                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        if mode == "alone":
                            for _ in Stamped():
                                pass
                        else:
                            valid_one_epoch(model, Stamped(), step, -1, output_file=out,
                                            print_freq=10 ** 6)
                        torch.cuda.synchronize()
                        t1 = time.perf_counter()
                        n = len(arrivals)
                        print(f"batcher {mode}, {nw} workers: {n} batches, "
                              f"{bsz * n / (t1 - t0):.1f} videos/s over the epoch, "
                              f"{bsz * (n - 1) / (t1 - arrivals[0]):.1f} after the first "
                              f"batch; arrivals {[round((a - t0) * 1e3) for a in arrivals]} "
                              f"ms; copy-out {np.mean(copy_ms):.1f} ms a batch [{smi}]",
                              flush=True)
        pipeline._Pool.copy_out = copy_out
        with pipeline.Batcher(ds, bsz, shuffle=False, drop_last=False, num_workers=4,
                              max_div_factor=32, empty=pipeline.pinned_empty) as b:
            held = list(b)
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            valid_one_epoch(model, held, step, -1, output_file=out, print_freq=10 ** 6)
            torch.cuda.synchronize()
            print(f"valid_one_epoch on {len(held)} batches already pinned: "
                  f"{bsz * len(held) / (time.perf_counter() - t0):.1f} videos/s [{smi}]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
