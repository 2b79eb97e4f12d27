"""The model FLOPs of one eval forward of a configuration with the dependency
block, counted on the plain reference with it (reference/dependency.py) by
portbench/flops.py's rules (its formulas, imported), and pinned into the
configuration's file. No cell trains such a configuration, so there is no
train count.

    python -m portbench.flops_dependency portbench/configs/<config>.json --batch 64 [--write]
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import torch

from .flops import _formulas
from .reference import dependency as ref_dep


def model_flops(cfg: Dict, batch: int) -> int:
    """FLOPs of one eval forward of `batch` videos of the full length."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    m = cfg["model"]
    t = m["max_seq_len"]
    model = ref_dep.build(m, "cpu").eval()
    counter = FlopCounterMode(display=False, custom_mapping=_formulas())
    with FakeTensorMode(allow_non_fake_inputs=True):
        b = {"visual": torch.zeros(batch, t, m["raw_input_dim_V"]),
             "audio": torch.zeros(batch, t, m["raw_input_dim_A"]),
             "mask": torch.ones(batch, t, dtype=torch.bool)}
        with counter, torch.no_grad():
            model(b)
    return int(counter.get_total_flops())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", help="a portbench/configs/<config>.json file")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--write", action="store_true", help="pin the count into the file")
    args = ap.parse_args(argv)
    with open(args.config) as f:
        doc = json.load(f)
    counts = {"eval_per_video": model_flops(doc["config"], args.batch) / args.batch,
              "batch": args.batch}
    print(json.dumps(counts))
    if args.write:
        doc["flops"] = counts
        with open(args.config, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
