"""The port's grads-gap tool (`tools/grad_gaps.py`) on a tiny model, on CPU:
`gate_margins` records one row per CSP gate of a train step's forward,
puts back what it wraps, and leaves the step's loss and grads bit for bit
as they are without it; `ulp_bump` moves one valid value of each row by
one bf16 ulp."""

import copy

import torch

from unav_yolyolva_tpu_torch.core import load_config_dict
from unav_yolyolva_tpu_torch.data.synthetic import synthetic_train_batch
from unav_yolyolva_tpu_torch.models import build_model
from unav_yolyolva_tpu_torch.ops import fused_csp
import pytest

from unav_yolyolva_tpu_torch.tools.grad_gaps import gate_margins, step_grads, ulp_bump
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)

T, NCLS = 64, 5


def test_gate_margins_record_each_gate_and_change_nothing():
    cfg = load_config_dict({
        "dataset": {"num_classes": NCLS, "max_seq_len": T, "max_num_events": 8},
        "model": {"raw_input_dim_V": 64, "raw_input_dim_A": 16, "input_dim_V": 32,
                  "input_dim_A": 32, "embd_dim": 32, "head_dim": 32, "use_abs_pe": True,
                  "class_aware": True},
        "train_cfg": {"loss_weight": 1},
    })
    model = build_model(cfg, device="cpu", seed=0)
    for mod in model.modules():
        if hasattr(mod, "drop_prob"):
            mod.drop_prob = 0.0
    batch = synthetic_train_batch(torch.Generator().manual_seed(2), 2, T, 64, 16, NCLS, 8)
    plain, einsum = fused_csp.csp_reference, torch.einsum
    rows = []
    with gate_margins(rows):
        loss, grads = step_grads(copy.deepcopy(model), cfg, batch, torch.device("cpu"))
    assert fused_csp.csp_reference is plain and torch.einsum is einsum
    ref_loss, ref = step_grads(copy.deepcopy(model), cfg, batch, torch.device("cpu"))
    assert loss == ref_loss
    assert all((g is None and ref[n] is None) or torch.equal(g, ref[n])
               for n, g in grads.items())
    # the five top-down layers (coarse to fine), then the five bottom-up
    assert [r[0] for r in rows] == [4, 8, 16, 32, 64, 32, 16, 8, 4, 2]
    assert all(0.0 <= low <= 1.0 and 0 <= n5 <= n and n > 0 for _, low, n5, n in rows)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ulp_bump_moves_one_valid_value_a_row_by_one_bf16_ulp(dtype):
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4, 9, 5, generator=gen).to(dtype)
    x[0, 0, :] = 0.0                                   # a zero moves up, never to a NaN
    mask = torch.arange(9)[None, :] < torch.tensor([1, 9, 0, 4])[:, None]
    for sign in (1, -1):
        y = ulp_bump(x, mask, gen, sign)
        moved = (y.bfloat16() != x.bfloat16()).nonzero().tolist()
        assert [i for i, *_ in moved] == [0, 1, 3]     # one a row; none in the empty row
        for i, j, k in moved:
            assert mask[i, j]
            a, b = x[i, j, k].bfloat16(), y[i, j, k].bfloat16()
            steps = int(b.view(torch.int16)) - int(a.view(torch.int16))
            assert steps == (sign if float(a) != 0 else 1)
        assert torch.equal(y - x, (y - x) * (y.bfloat16() != x.bfloat16()))
