"""The port's CUDA kernels against their plain versions on the card, at
small shapes. Marked `gpu`: on a machine without a card every test skips
(decided inside the fixture, never at import). Run on the card with
`python -m pytest -m gpu tests/test_torch_port_gpu.py`.

Tolerances: rtol 1e-3, atol 1e-4 for fp32 with another summation order;
NMS indices equal wherever neighbouring scores differ by more than 1e-6,
scores within rtol 1e-5."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

RTOL, ATOL = 1e-3, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    from unav_yolyolva_tpu_torch.core import resolve_device

    return resolve_device("cuda")


def _mask(b, t, lengths, dev):
    return torch.arange(t, device=dev)[None, :] < torch.tensor(lengths, device=dev)[:, None]


def _mhca_weights(c, gen, dev):
    return (torch.randn(3, c, 3, generator=gen) * 0.5,
            1 + 0.1 * torch.randn(3, c, generator=gen), 0.1 * torch.randn(3, c, generator=gen),
            torch.randn(4, c, c, generator=gen) / c ** 0.5,
            0.1 * torch.randn(4, c, generator=gen))


@pytest.mark.parametrize("t,c,heads", [(40, 64, 4), (7, 128, 4), (64, 96, 3)])
def test_mhca_kernel(cuda, t, c, heads):
    from unav_yolyolva_tpu_torch.ops.fused_mhca import fused_mhca, mhca_reference

    gen = torch.Generator().manual_seed(0)
    b = 3
    x1, x2 = torch.randn(b, t, c, generator=gen), torch.randn(b, t, c, generator=gen)
    ws = [w.to(cuda) for w in _mhca_weights(c, gen, cuda)]
    x1, x2 = x1.to(cuda), x2.to(cuda)
    mask = _mask(b, t, [t, t // 2, 0], cuda)
    out = fused_mhca(x1, x2, mask, *ws, heads=heads)
    ref = mhca_reference(x1, x2, mask, *ws, heads=heads)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
    assert (out[2] == 0).all()


@pytest.mark.parametrize("t,heads", [(7, 4), (20, 8)])
def test_csp_kernel(cuda, t, heads):
    from unav_yolyolva_tpu_torch.ops.fused_csp import csp_reference, fused_csp

    gen = torch.Generator().manual_seed(1)
    b, cin, mid, ng, fg = 3, 128, 64, 40, 24
    packs = [_mhca_weights(mid, gen, cuda) for _ in range(3)]
    stacked = [torch.stack([p[i] for p in packs]) for i in range(5)]
    args = [torch.randn(b, t, cin, generator=gen), torch.randn(b, ng, fg, generator=gen),
            None, torch.randn(2 * mid, cin, generator=gen) / cin ** 0.5,
            0.1 * torch.randn(2 * mid, generator=gen), *stacked,
            torch.randn(mid, fg, generator=gen) / fg ** 0.5, 0.1 * torch.randn(mid, generator=gen),
            torch.randn(heads, generator=gen),
            torch.randn(mid, mid, 3, generator=gen) / (3 * mid) ** 0.5,
            0.1 * torch.randn(mid, generator=gen),
            torch.randn(cin, 6 * mid, generator=gen) / (6 * mid) ** 0.5,
            0.1 * torch.randn(cin, generator=gen)]
    args = [a.to(cuda) if a is not None else _mask(b, t, [t, 3, t - 1], cuda) for a in args]
    out = fused_csp(*args, attn_heads=heads)
    ref = csp_reference(*args, attn_heads=heads)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)


def test_nms_kernel(cuda):
    from unav_yolyolva_tpu_torch.ops.fused_nms import (multiclass_soft_nms,
                                                       multiclass_soft_nms_reference)

    gen = torch.Generator().manual_seed(2)
    g, n = 5, 3000
    start = torch.rand(g, n, generator=gen) * 100
    segs = torch.stack([start, start + 1 + torch.rand(g, n, generator=gen) * 20], -1)
    scores = torch.rand(g, n, generator=gen)
    scores[torch.rand(g, n, generator=gen) < 0.3] = float("-inf")
    scores[-1] = float("-inf")
    cls = torch.randint(0, 20, (g, n), generator=gen, dtype=torch.int32)
    kw = dict(max_out=100, sigma=0.4, min_score=0.001)
    segs, scores, cls = segs.to(cuda), scores.to(cuda), cls.to(cuda)
    ki, ks, _ = multiclass_soft_nms(segs, scores, cls, **kw)
    ri, rs, _ = multiclass_soft_nms_reference(segs, scores, cls, **kw)
    ki, ks, ri, rs = (x.cpu().numpy() for x in (ki, ks, ri, rs))
    np.testing.assert_allclose(ks, rs, rtol=1e-5, atol=1e-7)
    d = np.abs(np.diff(rs, axis=1))
    gap = np.full(rs.shape, np.inf)
    gap[:, 1:] = np.minimum(gap[:, 1:], d)
    gap[:, :-1] = np.minimum(gap[:, :-1], d)
    np.testing.assert_array_equal(ki[gap > 1e-6], ri[gap > 1e-6])
    assert (ki[-1] == -1).all()


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from unav_yolyolva_tpu_torch.ops.fused_mhca import fused_mhca

    x = torch.randn(2, 8, 64, device=cuda)
    ws = [w.to(cuda) for w in _mhca_weights(64, torch.Generator().manual_seed(3), cuda)]
    with pytest.raises(ValueError):
        fused_mhca(x.double(), x.double(), _mask(2, 8, [8, 8], cuda), *ws, heads=4)


def test_eval_step_cuda_matches_cpu(cuda):
    """A small model through make_eval_step on the card and on the CPU."""
    import copy

    from unav_yolyolva_tpu_torch.core import load_config_dict
    from unav_yolyolva_tpu_torch.data.synthetic import synthetic_eval_batch
    from unav_yolyolva_tpu_torch.eval import make_eval_step
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.ops.fused_csp import fused_csp
    from unav_yolyolva_tpu_torch.ops.fused_mhca import fused_mhca
    from unav_yolyolva_tpu_torch.ops.fused_nms import multiclass_soft_nms

    cfg = load_config_dict({
        "dataset": {"num_classes": 5, "max_seq_len": 64},
        "model": {"raw_input_dim_V": 64, "raw_input_dim_A": 16, "input_dim_V": 64,
                  "input_dim_A": 64, "embd_dim": 64, "head_dim": 64, "use_abs_pe": True},
        "test_cfg": {"pre_nms_topk": 100, "max_seg_num": 20, "min_score": 0.001,
                     "nms_sigma": 0.4, "iou_threshold": 0.7},
    })
    model = build_model(cfg, device=cuda, seed=0)
    batch = synthetic_eval_batch(torch.Generator().manual_seed(4), 4, 64, 64, 16)
    before = (fused_mhca.launches, fused_csp.launches, multiclass_soft_nms.launches)
    gpu = {k: v.cpu() for k, v in make_eval_step(model, cfg, cuda)(batch).items()}
    after = (fused_mhca.launches, fused_csp.launches, multiclass_soft_nms.launches)
    assert [a - b for a, b in zip(after, before)] == [5, 10, 1]
    cpu = make_eval_step(copy.deepcopy(model).cpu(), cfg, "cpu")(batch)
    assert torch.equal(gpu["valid"], cpu["valid"])
    ok = cpu["valid"]
    torch.testing.assert_close(gpu["scores"][ok], cpu["scores"][ok], rtol=1e-3, atol=1e-6)
    assert not ok[-1].any()
