"""The model FLOPs of a configuration, counted on the frozen reference on fake
tensors, and pinned into the configuration's file so that no run pays for
the count.

    python -m portbench.flops portbench/configs/<config>.json --batch 64 [--write]

The counting rules are the program's tools/flops.py's, copied: the products
and convolutions that FlopCounterMode sees (a product counts 2 x M x N x K;
one whose contraction has a single element, or a dot of one row and one
column, counts nothing), a convolution's backward the forward's products
once for the input's gradient and once for the weight's, and no elementwise
work, normalization, softmax, decode or NMS. Eval: one forward of `batch`
videos of the configuration's full length. Train: the training forward with
the losses and the gradient of the final loss with respect to every
parameter, the targets made before the count.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import numpy as np
import torch

from .reference import model as ref_model
from .reference import train as ref_train


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                        _dilation, transposed, _output_padding, _groups, output_mask,
                        out_shape=None, **kwargs) -> int:
    from torch.utils.flop_counter import conv_flop_count

    return conv_flop_count(x_shape, w_shape, grad_out_shape, transposed) * sum(
        bool(m) for m in output_mask[:2])


def _matrix(formula, a: int):
    def count(*shapes, out_shape=None, **kwargs):
        lhs, rhs = shapes[a], shapes[a + 1]
        return 0 if lhs[-1] == 1 or lhs[-2] == rhs[-1] == 1 else formula(*shapes)
    return count


def _formulas():
    from torch.utils import flop_counter as fc

    aten = torch.ops.aten
    return {aten.mm: _matrix(fc.mm_flop, 0), aten.bmm: _matrix(fc.bmm_flop, 0),
            aten.addmm: _matrix(fc.addmm_flop, 1),
            aten.baddbmm: _matrix(fc.baddbmm_flop, 1),
            aten.convolution_backward: _conv_backward_flop}


def model_flops(cfg: Dict, batch: int, train: bool = False) -> int:
    """FLOPs of one eval forward or one train step's forward and backward."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    m = cfg["model"]
    t, n = m["max_seq_len"], cfg["dataset"]["max_num_events"]
    model = ref_model.build(m, "cpu")
    model.train(train)
    points = torch.from_numpy(np.concatenate(ref_model.generate_points(
        t, m["regression_range"], m["scale_factor"])))
    counter = FlopCounterMode(display=False, custom_mapping=_formulas())
    with FakeTensorMode(allow_non_fake_inputs=True):
        b = {"visual": torch.zeros(batch, t, m["raw_input_dim_V"]),
             "audio": torch.zeros(batch, t, m["raw_input_dim_A"]),
             "mask": torch.ones(batch, t, dtype=torch.bool)}
        if not train:
            with counter, torch.no_grad():
                model(b)
        else:
            seg, lab = torch.zeros(batch, n, 2), torch.zeros(batch, n, dtype=torch.long)
            gv = torch.zeros(batch, n, dtype=torch.bool)
            scores, se, labels = ref_train.frame_targets(seg, lab, gv, t, m["num_classes"])
            gt_cls, gt_reg = ref_train.assign_labels(points, seg, lab, gv, m["num_classes"])
            with counter:
                out = model(b, targets=(se, scores, labels))
                losses, _ = ref_train.losses(out, gt_cls, gt_reg,
                                             torch.tensor(float(cfg["train_cfg"]["init_loss_norm"])),
                                             cfg)
                torch.autograd.grad(losses["final_loss"], list(model.parameters()),
                                    allow_unused=True)
    return int(counter.get_total_flops())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", help="a portbench/configs/<config>.json file")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--write", action="store_true", help="pin the counts into the file")
    args = ap.parse_args(argv)
    with open(args.config) as f:
        doc = json.load(f)
    counts = {"eval_per_video": model_flops(doc["config"], args.batch) / args.batch,
              "train_per_clip": model_flops(doc["config"], args.batch, True) / args.batch,
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
