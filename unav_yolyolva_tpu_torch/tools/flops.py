"""The model's FLOPs at a configuration, counted the same whatever implements
a layer: the yardstick of the bench's model-FLOP utilization.

    model_flops(cfg, batch, train=False) -> int

It builds the model on the CPU from `cfg` at fp32 (the bf16 policy runs the
same products; its plain versions emulate some of them in several bf16
terms, which must not count), with the stem held on its module path while it
counts (models/blocks.py:FUSED_TBLOCK and the UNAV_FUSED_TBLOCK environment
variable, restored after), and runs it on fake tensors
(`torch._subclasses.fake_tensor.FakeTensorMode`) inside
`torch.utils.flop_counter.FlopCounterMode`: no arithmetic runs, so the
count depends on the configuration and the batch alone. On CPU tensors
every kernel wrapper runs its plain version, so the count is of the plain
path's aten products and convolutions, the plain kernel versions' included:
the hand-written kernels (ctypes calls) are invisible to the counter and
cannot move it. A product counts 2 x M x N x K; one whose contraction has a
single element (an outer product, as the backward of a per-row dot makes)
is elementwise work and counts nothing, as a broadcast multiply does. A
convolution's backward counts the forward's products once for the input's
gradient and once for the weight's (torch's own formula counts a grouped
convolution's weight gradient as a dense one). It does not count
elementwise work, normalizations, softmax, decode or NMS.

Eval (train=False): `model(batch, with_losses=False)` on `batch` videos of
the configuration's full length. Train: the forward in training mode with
the losses, `compute_losses` and the gradient of `final_loss` with respect
to every parameter; the targets (`build_targets`) are made before the count
starts, and the optimizer's update, the clip and the EMA are elementwise.
tests/test_torch_port_bench.py holds the count to the products and
convolutions of the JAX package's model at the same configuration. The
nearest earlier count is the JAX bench's 29.106 GFLOP a video at the eval
protocol (BENCH_r05.json: XLA's cost analysis plus the Pallas kernels'
traced FLOPs, elementwise work included); this one reads 28.70.
"""

from __future__ import annotations

import copy
import os
from typing import Dict

import torch


def _inputs(cfg: Dict, batch: int, train: bool) -> Dict[str, torch.Tensor]:
    m = cfg["model"]
    t = m["max_seq_len"]
    out = {"visual": torch.zeros(batch, t, m.get("raw_input_dim_V", 2048)),
           "audio": torch.zeros(batch, t, m.get("raw_input_dim_A", 128)),
           "mask": torch.ones(batch, t, dtype=torch.bool)}
    if train:
        n = cfg["dataset"]["max_num_events"]
        out["gt_segments"] = torch.zeros(batch, n, 2)
        out["gt_labels"] = torch.zeros(batch, n, dtype=torch.long)
        out["gt_valid"] = torch.zeros(batch, n, dtype=torch.bool)
    return out


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                        _dilation, transposed, _output_padding, _groups, output_mask,
                        out_shape=None, **kwargs) -> int:
    """aten.convolution_backward: the input's and the weight's gradient each
    cost the forward's products."""
    from torch.utils.flop_counter import conv_flop_count

    return conv_flop_count(x_shape, w_shape, grad_out_shape, transposed) * sum(
        bool(m) for m in output_mask[:2])


def _matrix(formula, a: int):
    """`formula` of a product whose operands are shapes[a] and shapes[a + 1],
    or 0 where it is a vector product: a contraction over one element (an
    outer product) or rows and columns of one element each (a dot)."""
    def count(*shapes, out_shape=None, **kwargs):
        lhs, rhs = shapes[a], shapes[a + 1]
        return 0 if lhs[-1] == 1 or lhs[-2] == rhs[-1] == 1 else formula(*shapes)
    return count


def _formulas():
    """FlopCounterMode's formulas where this count's rules differ from
    torch's own."""
    from torch.utils import flop_counter as fc

    aten = torch.ops.aten
    return {aten.mm: _matrix(fc.mm_flop, 0), aten.bmm: _matrix(fc.bmm_flop, 0),
            aten.addmm: _matrix(fc.addmm_flop, 1),
            aten.baddbmm: _matrix(fc.baddbmm_flop, 1),
            aten.convolution_backward: _conv_backward_flop}


def model_flops(cfg: Dict, batch: int, train: bool = False) -> int:
    """FLOPs of one eval forward (train=False) or one train step's forward
    and backward (train=True) of `batch` videos at `cfg`'s model."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from ..geometry.points import concat_points, generate_points
    from ..models import blocks, build_model
    from ..models.meta_arch import compute_losses
    from ..train.step import build_targets, loss_kwargs

    cfg = copy.deepcopy(cfg)
    cfg["tpu"]["compute_dtype"] = "float32"
    m = cfg["model"]
    saved_env, saved_mode = os.environ.pop("UNAV_FUSED_TBLOCK", None), blocks.FUSED_TBLOCK
    blocks.FUSED_TBLOCK = "never"
    try:
        model = build_model(cfg, device="cpu", seed=None)
        model.train(train)
        points = torch.from_numpy(concat_points(generate_points(
            m["max_seq_len"], m["regression_range"], m["scale_factor"])))
        counter = FlopCounterMode(display=False, custom_mapping=_formulas())
        with FakeTensorMode(allow_non_fake_inputs=True):
            b = _inputs(cfg, batch, train)
            if not train:
                with counter, torch.no_grad():
                    model(b, with_losses=False)
            else:
                m_scores, m_start_end, m_labels, gt_cls, gt_reg = build_targets(
                    b, points, m["max_seq_len"], m["num_classes"], m["class_aware"])
                inputs = {"visual": b["visual"], "audio": b["audio"], "mask": b["mask"],
                          "m_scores": m_scores, "m_start_end": m_start_end,
                          "m_labels": m_labels}
                with counter:
                    out = model(inputs, with_losses=True,
                                generator=torch.Generator().manual_seed(0))
                    losses, _ = compute_losses(
                        out, gt_cls, gt_reg, torch.tensor(cfg["train_cfg"]["init_loss_norm"]),
                        **loss_kwargs(cfg))
                    params = [p for p in model.parameters() if p.requires_grad]
                    torch.autograd.grad(losses["final_loss"], params, allow_unused=True)
        return int(counter.get_total_flops())
    finally:
        blocks.FUSED_TBLOCK = saved_mode
        if saved_env is not None:
            os.environ["UNAV_FUSED_TBLOCK"] = saved_env
