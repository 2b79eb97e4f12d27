"""The port's CUDA kernels against their plain versions on the card, at
small shapes, and the entry points on the card against the CPU. Marked
`gpu`: on a machine without a card every test skips (decided inside the
fixture, never at import). Run on the card with
`python -m pytest -m gpu tests/test_torch_port_gpu.py`.

Tolerances: rtol 1e-3, atol 1e-4 for fp32 with another summation order;
NMS indices equal wherever neighbouring scores differ by more than 1e-6,
scores within rtol 1e-5. Weight grads are sums over all R*T rows in another
order than the plain version's, so they are held norm-wise: ||k - p|| <=
1e-4 ||p|| per tensor; the backward kernels' two runs agree bit for bit.
The tensor-core product (3xTF32) is held against an fp64 product: its
norm-wise error within 2x that of the fp32 matmul (TF32 off)."""

import numpy as np
import pytest
import torch

from unav_yolyolva_tpu_torch.utils.profiling import is_kernel

pytestmark = pytest.mark.gpu

RTOL, ATOL = 1e-3, 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    from unav_yolyolva_tpu_torch.core import resolve_device
    from unav_yolyolva_tpu_torch.ops import cuda_build

    cuda_build.build()        # every library at once (one nvcc each), before the first use
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


def _normwise(name, got, ref, tol=1e-4):
    err = float((got - ref).norm() / ref.norm().clamp(min=1e-30))
    assert err <= tol, f"{name}: norm-wise relative error {err:.3e} > {tol}"


def _check_grads(kernel, plain, n_inputs):
    """Input grads element-wise, weight grads norm-wise."""
    for i, (k, p) in enumerate(zip(kernel, plain)):
        assert k.shape == p.shape and bool(torch.isfinite(k).all()), i
        if i < n_inputs:
            torch.testing.assert_close(k, p, rtol=RTOL, atol=ATOL)
        else:
            _normwise(f"grad {i}", k, p)


@pytest.mark.parametrize("r,t,c,heads", [(3, 40, 64, 4), (3, 7, 128, 4), (3, 64, 96, 3),
                                         (8, 224, 512, 4)])
def test_mhca_backward_kernel(cuda, r, t, c, heads):
    from unav_yolyolva_tpu_torch.ops.fused_mhca import mhca_backward, mhca_backward_reference

    gen = torch.Generator().manual_seed(5)
    x1, x2 = torch.randn(r, t, c, generator=gen), torch.randn(r, t, c, generator=gen)
    g = torch.randn(r, t, c, generator=gen)
    ws = [w.to(cuda) for w in _mhca_weights(c, gen, cuda)]
    x1, x2, g = x1.to(cuda), x2.to(cuda), g.to(cuda)
    lengths = [t, t // 2, 0] + [max(1, t - 3 * i) for i in range(r - 3)]
    mask = _mask(r, t, lengths, cuda)
    got = mhca_backward(x1, x2, mask, *ws, g, heads=heads)
    again = mhca_backward(x1, x2, mask, *ws, g, heads=heads)
    ref = mhca_backward_reference(x1, x2, mask, *ws, g, heads=heads)
    torch.cuda.synchronize()
    _check_grads(got, ref, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "not deterministic"
    assert (got[1][2] == 0).all(), "an all-masked row must get exact zero grads"


def _csp_args(gen, cuda, b, t, cin, mid, ng, fg, heads, cout=None):
    cout = cout or cin
    packs = [_mhca_weights(mid, gen, cuda) for _ in range(3)]
    stacked = [torch.stack([p[i] for p in packs]) for i in range(5)]
    guide = torch.randn(b, ng, fg, generator=gen)
    guide[:, 5] = guide[:, 3] = 3 * torch.randn(fg, generator=gen)   # tied maxima
    args = [torch.randn(b, t, cin, generator=gen), guide,
            None, torch.randn(2 * mid, cin, generator=gen) / cin ** 0.5,
            0.1 * torch.randn(2 * mid, generator=gen), *stacked,
            torch.randn(mid, fg, generator=gen) / fg ** 0.5, 0.1 * torch.randn(mid, generator=gen),
            torch.randn(heads, generator=gen),
            torch.randn(mid, mid, 3, generator=gen) / (3 * mid) ** 0.5,
            0.1 * torch.randn(mid, generator=gen),
            torch.randn(cout, 6 * mid, generator=gen) / (6 * mid) ** 0.5,
            0.1 * torch.randn(cout, generator=gen)]
    lengths = [t, 3, max(1, t - 1)] + [max(1, t - 5 * i) for i in range(b - 3)]
    return [a.to(cuda) if a is not None else _mask(b, t, lengths, cuda) for a in args]


@pytest.mark.parametrize("b,t,cin,mid,ng,fg,heads,cout",
                         [(3, 7, 128, 64, 40, 24, 4, 128), (3, 20, 128, 64, 40, 24, 8, 128),
                          (16, 224, 1024, 256, 512, 224, 8, 512)])
def test_csp_backward_kernel(cuda, b, t, cin, mid, ng, fg, heads, cout):
    from unav_yolyolva_tpu_torch.ops.fused_csp import csp_backward, csp_backward_reference

    gen = torch.Generator().manual_seed(6)
    args = _csp_args(gen, cuda, b, t, cin, mid, ng, fg, heads, cout)
    g = torch.randn(b, t, cout, generator=gen).to(cuda)
    got = csp_backward(*args, g=g, attn_heads=heads)
    again = csp_backward(*args, g=g, attn_heads=heads)
    ref = csp_backward_reference(*args, g=g, attn_heads=heads)
    torch.cuda.synchronize()
    _check_grads(got, ref, 2)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again)), "not deterministic"


def test_cuda_forward_with_grad_keeps_the_graph(cuda):
    """With grad enabled the CUDA forward is differentiable: the output has a
    grad_fn, and backward reaches the inputs and every packed weight through
    the backward kernels."""
    from unav_yolyolva_tpu_torch.ops.fused_csp import csp_backward, fused_csp
    from unav_yolyolva_tpu_torch.ops.fused_mhca import fused_mhca, mhca_backward

    gen = torch.Generator().manual_seed(7)
    x1 = torch.randn(2, 16, 64, generator=gen).to(cuda).requires_grad_(True)
    x2 = torch.randn(2, 16, 64, generator=gen).to(cuda).requires_grad_(True)
    ws = [w.to(cuda).requires_grad_(True) for w in _mhca_weights(64, gen, cuda)]
    before = mhca_backward.launches
    out = fused_mhca(x1, x2, _mask(2, 16, [16, 9], cuda), *ws, heads=4)
    assert out.requires_grad and out.grad_fn is not None
    out.square().sum().backward()
    assert mhca_backward.launches == before + 1
    for t_ in (x1, x2, *ws):
        assert t_.grad is not None and t_.grad.abs().sum() > 0

    args = _csp_args(gen, cuda, 3, 7, 128, 64, 40, 24, 4)
    args = [a if a.dtype == torch.bool else a.requires_grad_(True) for a in args]
    before = csp_backward.launches
    out = fused_csp(*args, attn_heads=4)
    assert out.requires_grad and out.grad_fn is not None
    out.square().sum().backward()
    assert csp_backward.launches == before + 1
    for i, a in enumerate(args):
        if a.dtype != torch.bool:
            assert a.grad is not None and a.grad.abs().sum() > 0, i


def _nms_rows(seed, g, n, ncls, kind, dev):
    """Candidate rows for the NMS kernels: overlapping segments with distinct
    random scores and ~30% dead lanes scattered (`scattered`), the live lanes
    first and score-descending as group_by_class gives them (`prefix`),
    eight score levels equal across and within classes (`ties`), the same
    on disjoint segments, where no score moves and the ties alone order
    the emissions (`apart`), or half the lanes in class 0 and a quarter in
    class 1 (`skewed`). Row 0 holds one class; the last row is all dead."""
    gen = torch.Generator().manual_seed(seed)
    if kind == "apart":
        start = torch.arange(n, dtype=torch.float32).expand(g, n) * 10
        segs = torch.stack([start, start + 5], -1)
    else:
        start = torch.rand(g, n, generator=gen) * 100
        segs = torch.stack([start, start + 1 + torch.rand(g, n, generator=gen) * 20], -1)
    scores = torch.rand(g, n, generator=gen)
    if kind in ("ties", "apart"):
        scores = torch.randint(1, 9, (g, n), generator=gen).float() / 8
    scores[torch.rand(g, n, generator=gen) < 0.3] = float("-inf")
    if kind == "prefix":
        scores = scores.sort(dim=1, descending=True).values
    scores[-1] = float("-inf")
    cls = torch.randint(0, ncls, (g, n), generator=gen, dtype=torch.int32)
    if kind == "skewed":
        cls[:, : n // 2], cls[:, n // 2: 3 * n // 4] = 0, 1
    cls[0] = 0
    return segs.contiguous().to(dev), scores.contiguous().to(dev), cls.to(dev)


def _assert_nms(out, again, ref, exact):
    """Scores within rtol 1e-5, indices equal where neighbouring scores
    differ by more than 1e-6 (everywhere when `exact`), the same bits on
    repeat, and the all-dead last row empty."""
    ki, ks, _ = out
    assert torch.equal(ki, again[0]) and torch.equal(ks, again[1])
    ki, ks, ri, rs = (x.cpu().numpy() for x in (ki, ks, ref[0], ref[1]))
    np.testing.assert_allclose(ks, rs, rtol=1e-5, atol=1e-7)
    d = np.abs(np.diff(rs, axis=1))
    gap = np.full(rs.shape, np.inf)
    gap[:, 1:] = np.minimum(gap[:, 1:], d)
    gap[:, :-1] = np.minimum(gap[:, :-1], d)
    sure = np.ones_like(ki, bool) if exact else gap > 1e-6
    np.testing.assert_array_equal(ki[sure], ri[sure])
    assert (ki[-1] == -1).all() and (ks[-1] == 0).all()


@pytest.mark.parametrize("n,ncls,kind,max_out", [
    (3000, 20, "scattered", 100), (1, 3, "scattered", 5), (2000, 100, "prefix", 100),
    (10100, 100, "scattered", 100), (10100, 100, "skewed", 100), (16384, 100, "scattered", 100),
    (3000, 300, "scattered", 100), (2000, 4, "ties", 100), (500, 5, "apart", 600)])
def test_nms_kernel(cuda, n, ncls, kind, max_out):
    from unav_yolyolva_tpu_torch.ops.fused_nms import (multiclass_soft_nms,
                                                       multiclass_soft_nms_reference)

    segs, scores, cls = _nms_rows(2, 5, n, ncls, kind, cuda)
    kw = dict(max_out=max_out, sigma=0.4, min_score=0.001)
    before = multiclass_soft_nms.launches
    out = multiclass_soft_nms(segs, scores, cls, **kw)
    again = multiclass_soft_nms(segs, scores, cls, **kw)
    assert multiclass_soft_nms.launches == before + 2
    _assert_nms(out, again, multiclass_soft_nms_reference(segs, scores, cls, **kw),
                exact=kind == "apart")


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from unav_yolyolva_tpu_torch.ops.fused_mhca import fused_mhca

    x = torch.randn(2, 8, 64, device=cuda)
    ws = [w.to(cuda) for w in _mhca_weights(64, torch.Generator().manual_seed(3), cuda)]
    with pytest.raises(ValueError):
        fused_mhca(x.double(), x.double(), _mask(2, 8, [8, 8], cuda), *ws, heads=4)
    from unav_yolyolva_tpu_torch.ops.fused_csp import csp_backward
    from unav_yolyolva_tpu_torch.ops.fused_mhca import mhca_backward

    mask = _mask(2, 8, [8, 8], cuda)
    with pytest.raises(ValueError):                      # grad of another shape
        mhca_backward(x, x, mask, *ws, x[:, :4].contiguous(), heads=4)
    with pytest.raises(ValueError):                      # C not a multiple of heads
        mhca_backward(x, x, mask, *ws, x, heads=3)
    args = _csp_args(torch.Generator().manual_seed(8), cuda, 3, 7, 128, 64, 40, 24, 4)
    with pytest.raises(ValueError):                      # a CPU grad
        csp_backward(*args, g=torch.zeros(3, 7, 128), attn_heads=4)


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


def test_train_step_cuda_matches_cpu(cuda):
    """Two steps of make_train_step on a small model, on the card and on the
    CPU, from the same weights: the losses agree, and every parameter after
    the update agrees to 2 x lr, with 99% of its elements within 1e-2 x lr
    (Adam normalizes each update, so rounding in a near-zero grad can flip
    a step's sign: the error's bound is the learning rate); the backward
    kernels run once per forward."""
    import copy

    from unav_yolyolva_tpu_torch.core import load_config_dict
    from unav_yolyolva_tpu_torch.data.synthetic import synthetic_train_batch
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.ops.fused_csp import csp_backward, fused_csp
    from unav_yolyolva_tpu_torch.ops.fused_mhca import fused_mhca, mhca_backward
    from unav_yolyolva_tpu_torch.train import (create_train_state, make_optimizer,
                                               make_train_step)

    lr = 1e-3
    cfg = load_config_dict({
        "dataset": {"num_classes": 5, "max_seq_len": 64, "max_num_events": 8},
        "model": {"raw_input_dim_V": 64, "raw_input_dim_A": 16, "input_dim_V": 64,
                  "input_dim_A": 64, "embd_dim": 64, "head_dim": 64, "use_abs_pe": True},
        "opt": {"learning_rate": lr, "epochs": 2, "warmup_epochs": 1, "weight_decay": 1e-4},
        "train_cfg": {"loss_weight": 1, "droppath": 0.0},
    })
    gen = torch.Generator().manual_seed(9)
    batches = [synthetic_train_batch(gen, 2, 64, 64, 16, 5, 8) for _ in range(2)]
    base = build_model(cfg, device="cpu", seed=0)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        model = copy.deepcopy(base).to(dev)
        opt, _ = make_optimizer(model, cfg["opt"], 2)
        state = create_train_state(model, opt, 250.0)
        step = make_train_step(model, opt, cfg, device=dev)
        counts = (fused_mhca.launches, mhca_backward.launches, fused_csp.launches,
                  csp_backward.launches)
        losses = [step(state, b) for b in batches]
        after = (fused_mhca.launches, mhca_backward.launches, fused_csp.launches,
                 csp_backward.launches)
        runs[dev.type] = (losses, [p.detach().cpu() for p in model.parameters()],
                          [a - b for a, b in zip(after, counts)],
                          (step.eager_steps, step.captures, step.replays))
    (gl, gp, gc, gs), (cl, cp, cc, cs) = runs["cuda"], runs["cpu"]
    # the wrappers count a step that runs them: an eager or a captured one,
    # not a replay (the card: step 1 eager, step 2 captured and replayed)
    assert gs == (1, 1, 1) and cs == (2, 0, 0)
    assert gc == [10, 10, 20, 20] and cc == [0, 0, 0, 0]
    for a, b in zip(gl, cl):
        torch.testing.assert_close(a["final_loss"].cpu(), b["final_loss"], rtol=1e-4, atol=1e-6)
    for a, b in zip(gp, cp):
        torch.testing.assert_close(a, b, rtol=0, atol=2 * lr)
        assert float(((a - b).abs() <= 1e-2 * lr).float().mean()) >= 0.99


def _tblock_args(gen, cuda, r, t, c, heads, lengths, hid=None):
    hid = hid or 4 * c
    x = torch.randn(r, t, c, generator=gen)
    mult_a = 0.7 + 0.3 * torch.randn(r, 1, c, generator=gen)
    mult_a[min(1, r - 1)] = 0.0                                # a dropped branch
    mult_m = 1.3 + 0.3 * torch.randn(r, 1, c, generator=gen)
    ws = [1 + 0.1 * torch.randn(3, c, generator=gen), 0.1 * torch.randn(3, c, generator=gen),
          *_mhca_weights(c, gen, cuda),
          torch.randn(hid, c, generator=gen) / c ** 0.5, 0.1 * torch.randn(hid, generator=gen),
          torch.randn(c, hid, generator=gen) / hid ** 0.5, 0.1 * torch.randn(c, generator=gen)]
    return ([a.to(cuda) for a in (x,)] + [_mask(r, t, lengths, cuda)]
            + [a.to(cuda) for a in (mult_a, mult_m, *ws)])


@pytest.mark.parametrize("r,t,c,heads", [(3, 40, 64, 4), (3, 7, 128, 4), (3, 64, 96, 3)])
def test_tblock_kernel(cuda, r, t, c, heads):
    from unav_yolyolva_tpu_torch.ops.fused_tblock import fused_tblock, tblock_reference

    args = _tblock_args(torch.Generator().manual_seed(10), cuda, r, t, c, heads,
                        [t, t // 2, 0])
    before = fused_tblock.launches
    out = fused_tblock(*args, heads=heads)
    ref = tblock_reference(*args, heads=heads)
    torch.cuda.synchronize()
    assert fused_tblock.launches == before + 1
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("r,t,c,heads", [(3, 40, 64, 4), (3, 7, 128, 4), (4, 64, 96, 3)])
def test_tblock_backward_kernel(cuda, r, t, c, heads):
    from unav_yolyolva_tpu_torch.ops.fused_tblock import (tblock_backward,
                                                          tblock_backward_reference)

    gen = torch.Generator().manual_seed(11)
    args = _tblock_args(gen, cuda, r, t, c, heads, [t, 0] + [max(1, t - 5 * i)
                                                             for i in range(r - 2)])
    g = torch.randn(r, t, c, generator=gen).to(cuda)
    got = tblock_backward(*args, g=g, heads=heads)
    again = tblock_backward(*args, g=g, heads=heads)
    ref = tblock_backward_reference(*args, g=g, heads=heads)
    torch.cuda.synchronize()
    _check_grads(got, ref, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "not deterministic"
    assert (got[0][1] == 0).all(), "an all-masked row must get exact zero grads"


def test_tblock_forward_with_grad_keeps_the_graph(cuda):
    from unav_yolyolva_tpu_torch.ops.fused_tblock import fused_tblock, tblock_backward

    args = _tblock_args(torch.Generator().manual_seed(12), cuda, 2, 16, 64, 4, [16, 9])
    args = [a if a.dtype == torch.bool else a.requires_grad_(True) for a in args]
    before = tblock_backward.launches
    out = fused_tblock(*args, heads=4)
    assert out.requires_grad and out.grad_fn is not None
    out.square().sum().backward()
    assert tblock_backward.launches == before + 1
    for i, a in enumerate(args):
        if a.dtype != torch.bool:
            assert a.grad is not None and a.grad.abs().sum() > 0, i


@pytest.mark.parametrize("n,method,kind,max_out", [
    (300, 0, "scattered", 100), (300, 1, "scattered", 100), (1024, 2, "scattered", 100),
    (3000, 0, "scattered", 100), (3000, 2, "scattered", 100), (1, 2, "scattered", 4),
    (1024, 0, "prefix", 100), (1024, 1, "prefix", 100), (2000, 1, "scattered", 100),
    (10100, 2, "scattered", 100), (16384, 0, "scattered", 100), (16384, 2, "prefix", 100),
    (700, 2, "ties", 100), (400, 0, "apart", 450), (40, 1, "scattered", 50),
    (5000, 1, "apart", 100)])
def test_soft_nms_kernel(cuda, n, method, kind, max_out):
    from unav_yolyolva_tpu_torch.ops.fused_nms import soft_nms, soft_nms_reference

    segs, scores, _ = _nms_rows(13, 9, n, 1, kind, cuda)
    kw = dict(max_out=max_out, iou_threshold=0.5, sigma=0.4, min_score=0.001, method=method)
    before = soft_nms.launches
    out = soft_nms(segs, scores, **kw)
    again = soft_nms(segs, scores, **kw)
    assert soft_nms.launches == before + 2
    _assert_nms(out, again, soft_nms_reference(segs, scores, **kw), exact=kind == "apart")


def test_new_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from unav_yolyolva_tpu_torch.ops.fused_nms import soft_nms
    from unav_yolyolva_tpu_torch.ops.fused_tblock import fused_tblock, tblock_backward

    args = _tblock_args(torch.Generator().manual_seed(14), cuda, 2, 8, 64, 4, [8, 8])
    with pytest.raises(ValueError):                      # mult_a of another shape
        fused_tblock(args[0], args[1], args[2][:, :, :32].contiguous(), *args[3:], heads=4)
    with pytest.raises(ValueError):                      # C not a multiple of heads
        fused_tblock(*args, heads=3)
    with pytest.raises(ValueError):                      # a CPU grad
        tblock_backward(*args, g=torch.zeros(2, 8, 64), heads=4)
    segs = torch.zeros(2, 10, 2, device=cuda)
    with pytest.raises(ValueError):                      # no such method
        soft_nms(segs, torch.zeros(2, 10, device=cuda), max_out=3, iou_threshold=0.5,
                 sigma=0.5, min_score=0.0, method=3)


def _small_cfg(**test_cfg):
    from unav_yolyolva_tpu_torch.core import load_config_dict

    return load_config_dict({
        "dataset": {"num_classes": 5, "max_seq_len": 64, "max_num_events": 8},
        "model": {"raw_input_dim_V": 64, "raw_input_dim_A": 16, "input_dim_V": 64,
                  "input_dim_A": 64, "embd_dim": 64, "head_dim": 64, "use_abs_pe": True},
        "opt": {"learning_rate": 1e-3, "epochs": 2, "warmup_epochs": 1, "weight_decay": 1e-4},
        "train_cfg": {"loss_weight": 1, "droppath": 0.0},
        "test_cfg": {"pre_nms_topk": 100, "max_seg_num": 20, "min_score": 0.001,
                     "nms_sigma": 0.4, "iou_threshold": 0.7, **test_cfg},
    })


@pytest.mark.parametrize("stem,test_cfg", [
    ("always", {}), ("auto", {"nms_method": "hard"}),
    ("auto", {"multiclass_nms": False, "voting_thresh": 0.75})])
def test_eval_step_paths_cuda_match_cpu(cuda, stem, test_cfg):
    """The whole-block stem and the hard / single-class NMS configurations
    through make_eval_step on the card and on the CPU."""
    import copy

    import unav_yolyolva_tpu_torch.models.blocks as blocks
    from unav_yolyolva_tpu_torch.data.synthetic import synthetic_eval_batch
    from unav_yolyolva_tpu_torch.eval import make_eval_step
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.ops.fused_mhca import fused_mhca
    from unav_yolyolva_tpu_torch.ops.fused_nms import multiclass_soft_nms, soft_nms
    from unav_yolyolva_tpu_torch.ops.fused_tblock import fused_tblock

    cfg = _small_cfg(**test_cfg)
    model = build_model(cfg, device=cuda, seed=0)
    batch = synthetic_eval_batch(torch.Generator().manual_seed(4), 4, 64, 64, 16)
    fns = (fused_tblock, fused_mhca, multiclass_soft_nms, soft_nms)
    prev, blocks.FUSED_TBLOCK = blocks.FUSED_TBLOCK, stem
    try:
        before = [f.launches for f in fns]
        gpu = {k: v.cpu() for k, v in make_eval_step(model, cfg, cuda)(batch).items()}
        counts = [f.launches - b for f, b in zip(fns, before)]
        cpu = make_eval_step(copy.deepcopy(model).cpu(), cfg, "cpu")(batch)
    finally:
        blocks.FUSED_TBLOCK = prev
    merged = not test_cfg
    assert counts == [4 if stem == "always" else 0, 1 if stem == "always" else 5,
                      int(merged), int(not merged)]
    assert torch.equal(gpu["valid"], cpu["valid"])
    ok = cpu["valid"]
    torch.testing.assert_close(gpu["scores"][ok], cpu["scores"][ok], rtol=1e-3, atol=1e-6)
    assert not ok[-1].any()


def test_train_step_fused_stem_cuda_matches_cpu(cuda):
    """Two steps with the whole-block stem on the card and on the CPU from
    the same weights, as test_train_step_cuda_matches_cpu holds the default
    path; the block's backward kernel runs once per forward."""
    import copy

    import unav_yolyolva_tpu_torch.models.blocks as blocks
    from unav_yolyolva_tpu_torch.data.synthetic import synthetic_train_batch
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.ops.fused_tblock import fused_tblock, tblock_backward
    from unav_yolyolva_tpu_torch.train import (create_train_state, make_optimizer,
                                               make_train_step)

    lr = 1e-3
    cfg = _small_cfg()
    gen = torch.Generator().manual_seed(9)
    batches = [synthetic_train_batch(gen, 2, 64, 64, 16, 5, 8) for _ in range(2)]
    base = build_model(cfg, device="cpu", seed=0)
    runs = {}
    prev, blocks.FUSED_TBLOCK = blocks.FUSED_TBLOCK, "always"
    try:
        for dev in (cuda, torch.device("cpu")):
            model = copy.deepcopy(base).to(dev)
            opt, _ = make_optimizer(model, cfg["opt"], 2)
            state = create_train_state(model, opt, 250.0)
            step = make_train_step(model, opt, cfg, device=dev)
            counts = (fused_tblock.launches, tblock_backward.launches)
            losses = [step(state, b) for b in batches]
            runs[dev.type] = (losses, [p.detach().cpu() for p in model.parameters()],
                              [fused_tblock.launches - counts[0],
                               tblock_backward.launches - counts[1]],
                              (step.eager_steps, step.captures, step.replays))
    finally:
        blocks.FUSED_TBLOCK = prev
    (gl, gp, gc, gs), (cl, cp, cc, cs) = runs["cuda"], runs["cpu"]
    # per eager or captured step (not per replay), as in the default path's test
    assert gs == (1, 1, 1) and cs == (2, 0, 0)
    assert gc == [8, 8] and cc == [0, 0]
    for a, b in zip(gl, cl):
        torch.testing.assert_close(a["final_loss"].cpu(), b["final_loss"], rtol=1e-4, atol=1e-6)
    for a, b in zip(gp, cp):
        torch.testing.assert_close(a, b, rtol=0, atol=2 * lr)
        assert float(((a - b).abs() <= 1e-2 * lr).float().mean()) >= 0.99


def _tc_operands(gen, cuda, m, n, kc, taps):
    x = torch.randn(m, kc, generator=gen).to(cuda)
    w = (torch.randn(n, taps * kc, generator=gen) / (taps * kc) ** 0.5).to(cuda)
    return x, w


@pytest.mark.parametrize("case", ["ragged", "conv_edges", "slice_out", "rowmask"])
def test_tc_product_against_fp64(cuda, case):
    """The product alone at ragged shapes: M = 896 (T=7 at 2B=128), the k=3
    conv over sequences of 7 (every row near an edge), a strided
    column-slice output with bias and scale, a row mask with masked rows."""
    from unav_yolyolva_tpu_torch.ops.gemm_tc import conv3_taps, tf32x3_linear

    gen = torch.Generator().manual_seed(20)
    m, n, kc, taps, seq = {"ragged": (896, 256, 1536, 1, 1),
                           "conv_edges": (896, 256, 256, 3, 7),
                           "slice_out": (1000, 128, 224, 1, 1),
                           "rowmask": (1792, 512, 768, 1, 1)}[case]
    x, w = _tc_operands(gen, cuda, m, n, kc, taps)
    bias = 0.1 * torch.randn(n, generator=gen).to(cuda)
    scale = 0.125 if case == "slice_out" else 1.0
    rowmask = (torch.arange(m, device=cuda) % 7 != 3) if case == "rowmask" else None
    buf = torch.full((m, n + 64), 5.0, device=cuda)
    out = buf[:, 32:32 + n] if case == "slice_out" else None
    before = tf32x3_linear.launches
    y = tf32x3_linear(x, w, bias, rowmask=rowmask, scale=scale, taps=taps, seq=seq, out=out)
    again = tf32x3_linear(x, w, bias, rowmask=rowmask, scale=scale, taps=taps, seq=seq)
    torch.cuda.synchronize()
    assert tf32x3_linear.launches == before + 2
    a = conv3_taps(x, seq) if taps == 3 else x
    ref = (a.double() @ w.double().T + bias.double()) * scale
    y32 = (a @ w.T + bias) * scale
    if rowmask is not None:
        ref, y32 = ref * rowmask[:, None], y32 * rowmask[:, None]
        assert (y[~rowmask] == 0).all()
    err = float((y.double() - ref).norm() / ref.norm())
    err32 = float((y32.double() - ref).norm() / ref.norm())
    assert err <= 2 * err32, f"3xTF32 error {err:.3e} vs fp32 matmul {err32:.3e}"
    assert torch.equal(y, again), "not bit-identical on repeat"
    if out is not None:
        assert y.data_ptr() == out.data_ptr()
        assert (buf[:, :32] == 5).all() and (buf[:, 32 + n:] == 5).all()


def test_tc_product_bits_independent_of_batching(cuda):
    """A small product (T=7 shapes: the smallest tile alone) gives the same
    bits alone and batched with a large one (guide_fc: the largest tile),
    as the CSP backward's batched recompute needs."""
    from unav_yolyolva_tpu_torch.ops.gemm_tc import tf32x3_linear, tf32x3_products

    gen = torch.Generator().manual_seed(21)
    xs, ws = _tc_operands(gen, cuda, 896, 256, 256, 3)
    xb, wb = _tc_operands(gen, cuda, 65536, 256, 224, 1)
    bias = torch.randn(256, generator=gen).to(cuda)
    small = tf32x3_linear(xs, ws, bias, taps=3, seq=7)
    big = tf32x3_linear(xb, wb)
    pair = tf32x3_products([dict(x=xb, w=wb), dict(x=xs, w=ws, bias=bias, taps=3, seq=7)])
    torch.cuda.synchronize()
    assert torch.equal(pair[0], big) and torch.equal(pair[1], small)


@pytest.mark.parametrize("case", ["nn_conv_beta", "nn_ragged_rowmask", "wgrad_kmask",
                                  "wgrad_btaps", "wgrad_strided"])
def test_tc_backward_layouts_against_fp64(cuda, case):
    """The input-grad (A.B) and weight-grad (A^T.B) layouts alone: the
    transposed k=3 conv over sequences of 7 added into a strided column
    slice, a ragged M with a row mask, the final conv's weight grad (K =
    3584 rows, split K) with masked rows, the conv's weight grad over a
    ragged K = 1001 with the shifted-B loader, and a strided A read in place
    (a dcat slice). Error against fp64 within 2x fp32 matmul's; the same
    bits on repeat; the kernel's split of K is split_chunk's."""
    from unav_yolyolva_tpu_torch.ops.gemm_tc import (conv3_taps, kernel_split_chunk,
                                                     split_chunk, tf32x3_products)

    gen = torch.Generator().manual_seed(24)
    buf = None
    if case.startswith("nn"):
        m, kc, n, seq, taps = {"nn_conv_beta": (896, 256, 256, 7, 3),
                               "nn_ragged_rowmask": (1000, 512, 384, 1, 1)}[case]
        x = torch.randn(m, kc, generator=gen).to(cuda)
        w = (torch.randn(taps * kc, n, generator=gen) / (taps * kc) ** 0.5).to(cuda)
        call = dict(x=x, w=w, taps=taps, tapdir=-1, seq=seq, trans_b=True)
        a = conv3_taps(x, seq, -1) if taps == 3 else x
        ref, y32 = a.double() @ w.double(), a @ w
        if case == "nn_conv_beta":
            buf = torch.randn(m, n + 64, generator=gen).to(cuda)
            call.update(out=buf[:, 32:32 + n], beta=True)
            before = buf.clone()
            ref, y32 = ref + before[:, 32:32 + n].double(), y32 + before[:, 32:32 + n]
        else:
            rowmask = torch.arange(m, device=cuda) % 7 != 3
            call["rowmask"] = rowmask
            ref, y32 = ref * rowmask[:, None], y32 * rowmask[:, None]
    else:
        k, m, n, seq = {"wgrad_kmask": (3584, 512, 1536, 1), "wgrad_btaps": (1001, 128, 128, 7),
                        "wgrad_strided": (3584, 256, 256, 1)}[case]
        x = torch.randn(k, m, generator=gen).to(cuda)
        if case == "wgrad_strided":
            x = torch.randn(k, 6 * m, generator=gen).to(cuda)[:, 2 * m:3 * m]
        w = torch.randn(k, n, generator=gen).to(cuda)
        kmask = (torch.arange(k, device=cuda) % 5 != 2) if case == "wgrad_kmask" else None
        btaps = 3 if seq > 1 else 1
        call = dict(x=x, w=w, kmask=kmask, btaps=btaps, seq=seq, trans_a=True, trans_b=True)
        a = x * kmask[:, None] if kmask is not None else x
        b = conv3_taps(w, seq) if btaps == 3 else w
        ref, y32 = a.double().T @ b.double(), a.T @ b
        assert kernel_split_chunk(m, btaps * n, k) == split_chunk(m, btaps * n, k)
    y = tf32x3_products([call])[0]
    if buf is not None:
        buf.copy_(before)
    again = tf32x3_products([call])[0]
    torch.cuda.synchronize()
    err = float((y.double() - ref).norm() / ref.norm())
    err32 = float((y32.double() - ref).norm() / ref.norm())
    assert err <= 2 * err32, f"3xTF32 error {err:.3e} vs fp32 matmul {err32:.3e}"
    assert torch.equal(y, again), "not bit-identical on repeat"
    if buf is not None:
        assert torch.equal(buf[:, :32], before[:, :32]) and torch.equal(buf[:, 32 + n:],
                                                                        before[:, 32 + n:])


def test_tc_weight_grad_bits_independent_of_batching(cuda):
    """A weight grad gives the same bits alone and batched with others of
    other shapes (and so other splits of K), as the backward batches them."""
    from unav_yolyolva_tpu_torch.ops.gemm_tc import tf32x3_products

    gen = torch.Generator().manual_seed(25)
    k = 3584
    xs = [torch.randn(k, m, generator=gen).to(cuda) for m in (256, 512, 64)]
    ws = [torch.randn(k, n, generator=gen).to(cuda) for n in (256, 1536, 224)]
    kmask = torch.arange(k, device=cuda) % 9 != 4
    calls = [dict(x=x, w=w, kmask=kmask, trans_a=True, trans_b=True) for x, w in zip(xs, ws)]
    alone = [tf32x3_products([c])[0] for c in calls]
    batched = tf32x3_products(calls)
    again = tf32x3_products(calls[::-1])[::-1]
    torch.cuda.synchronize()
    for a, b, c in zip(alone, batched, again):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_csp_backward_routes_a_tie_across_tiles(cuda):
    """Three guide tokens of each row that tie at the max (_csp_args ties
    tokens 3 and 5; token 150 copies them, in another tile of guide_fc's
    product): the forward's and the backward's recomputed scores must keep
    the tie, so the three tokens get the same grad, split as torch.amax
    splits it; two runs give the same bits."""
    from unav_yolyolva_tpu_torch.ops.fused_csp import csp_backward, csp_backward_reference

    gen = torch.Generator().manual_seed(22)
    args = _csp_args(gen, cuda, 3, 20, 128, 64, 200, 24, 4)
    args[1][:, 150] = args[1][:, 3]
    g = torch.randn(3, 20, 128, generator=gen).to(cuda)
    got = csp_backward(*args, g=g, attn_heads=4)
    again = csp_backward(*args, g=g, attn_heads=4)
    ref = csp_backward_reference(*args, g=g, attn_heads=4)
    torch.cuda.synchronize()
    dguide = got[1]
    assert (dguide[:, 3].abs().sum(1) > 0).all()
    assert torch.equal(dguide[:, 3], dguide[:, 5]), "the tie was broken"
    assert torch.equal(dguide[:, 3], dguide[:, 150]), "the tie was broken across tiles"
    _check_grads(got, ref, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "not deterministic"


@pytest.mark.parametrize("case", ["fc1_gelu", "fc2_tail", "du_gelu_grad"])
def test_tc_epilogue_against_plain_and_fp64(cuda, case):
    """The epilogue product alone at the TBlock MLP's shapes with ragged M
    and N: fc1 + bias + GELU keeping its input, fc2 + bias + row mask +
    per-sequence multiplier + residual (beta on the forward layout), du =
    (gy W2) * GELU'(u) on the A.B layout. Against the plain version at
    rtol 1e-3 / atol 1e-4, against fp64 within 2x fp32 torch.matmul with
    the same epilogue, the same bits on repeat."""
    from unav_yolyolva_tpu_torch.ops.gemm_tc import (gelu_erf, gelu_erf_grad,
                                                     tf32x3_product_reference,
                                                     tf32x3_products)

    gen = torch.Generator().manual_seed(30)
    seq, m = 50, 150
    k, n = {"fc1_gelu": (96, 390), "fc2_tail": (392, 98), "du_gelu_grad": (96, 388)}[case]

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(cuda)

    x, bias = rnd(m, k), rnd(n, scale=0.1)
    if case == "fc1_gelu":
        w = rnd(n, k, scale=k ** -0.5)
        pre = torch.empty(m, n, device=cuda)
        call = dict(x=x, w=w, bias=bias, act="gelu", pre_out=pre)
        ref = gelu_erf(x.double() @ w.double().T + bias.double())
        y32 = gelu_erf(x @ w.T + bias)
    elif case == "fc2_tail":
        w, res, mult = rnd(n, k, scale=k ** -0.5), rnd(m, n), 1 + rnd(m // seq, n, scale=0.3)
        mask = torch.arange(m, device=cuda) % 9 != 4
        call = dict(x=x, w=w, bias=bias, rowmask=mask, seqmul=mult, seq=seq, out=res,
                    beta=True)
        rows = mask[:, None] * mult.repeat_interleave(seq, 0)
        ref = res.double() + (x.double() @ w.double().T + bias.double()) * rows.double()
        y32 = res + (x @ w.T + bias) * rows
    else:
        w, u = rnd(k, n, scale=k ** -0.5), rnd(m, n)
        call = dict(x=x, w=w, trans_b=True, act="gelu_grad", aux=u)
        ref = (x.double() @ w.double()) * gelu_erf_grad(u.double())
        y32 = (x @ w) * gelu_erf_grad(u)
    def fresh():                                       # beta adds into a copy of res
        return dict(call, out=call["out"].clone()) if "out" in call else call

    plain = tf32x3_product_reference(**dict(fresh(), pre_out=None))
    y, again = (tf32x3_products([fresh()])[0] for _ in range(2))
    torch.cuda.synchronize()
    torch.testing.assert_close(y, plain, rtol=RTOL, atol=ATOL)
    err = float((y.double() - ref).norm() / ref.norm())
    err32 = float((y32.double() - ref).norm() / ref.norm())
    assert err <= 2 * err32, f"3xTF32 error {err:.3e} vs fp32 matmul {err32:.3e}"
    assert torch.equal(y, again), "not bit-identical on repeat"


def test_tc_epilogue_bits_independent_of_tile_and_batching(cuda):
    """fc1 with GELU on the first 150 rows alone (the smallest tile) gives
    the bits of the same rows inside a 4096-row product (the largest), and
    its kept input is bit-equal to the product without the epilogue run
    batched with another product: the forward's and the backward's
    recompute's u agree bit for bit."""
    from unav_yolyolva_tpu_torch.ops.gemm_tc import tf32x3_products

    gen = torch.Generator().manual_seed(31)
    x = torch.randn(4096, 128, generator=gen).to(cuda)
    w = (torch.randn(512, 128, generator=gen) / 128 ** 0.5).to(cuda)
    b = (0.1 * torch.randn(512, generator=gen)).to(cuda)
    pre_small, pre_big = (torch.empty(r, 512, device=cuda) for r in (150, 4096))
    small = tf32x3_products([dict(x=x[:150], w=w, bias=b, act="gelu", pre_out=pre_small)])[0]
    big = tf32x3_products([dict(x=x, w=w, bias=b, act="gelu", pre_out=pre_big)])[0]
    plain = tf32x3_products([dict(x=x[:150], w=w, bias=b), dict(x=x, w=w)])[0]
    torch.cuda.synchronize()
    assert torch.equal(small, big[:150]) and torch.equal(pre_small, pre_big[:150])
    assert torch.equal(pre_small, plain)


def test_tc_epilogue_refuses_what_it_does_not_take(cuda):
    from unav_yolyolva_tpu_torch.ops.gemm_tc import tf32x3_products

    x = torch.randn(64, 32, device=cuda)
    w = torch.randn(48, 32, device=cuda)
    u = torch.randn(64, 49, device=cuda)
    with pytest.raises(ValueError):                      # a weight grad takes no epilogue
        tf32x3_products([dict(x=x, w=torch.randn(64, 48, device=cuda), trans_a=True,
                              trans_b=True, act="gelu")])
    with pytest.raises(ValueError):                      # aux rows of odd length
        tf32x3_products([dict(x=x, w=w, act="gelu_grad", aux=u[:, 1:])])
    with pytest.raises(ValueError):                      # GELU' without its input
        tf32x3_products([dict(x=x, w=w, act="gelu_grad")])


def test_tc_wrappers_refuse_unaligned_operands(cuda):
    from unav_yolyolva_tpu_torch.ops.fused_mhca import fused_mhca
    from unav_yolyolva_tpu_torch.ops.gemm_tc import tf32x3_linear

    x = torch.randn(8, 65, device=cuda)
    w = torch.randn(16, 64, device=cuda)
    with pytest.raises(ValueError):                      # rows not on 16 bytes
        tf32x3_linear(x[:, 1:], w)
    with pytest.raises(ValueError):                      # head width 18: not whole chunks
        x3 = torch.randn(2, 8, 72, device=cuda)
        ws = [w_.to(cuda) for w_ in _mhca_weights(72, torch.Generator().manual_seed(3), cuda)]
        fused_mhca(x3, x3, _mask(2, 8, [8, 8], cuda), *ws, heads=4)


def _files(root, num_videos=16, num_classes=5, max_len=64):
    from unav_yolyolva_tpu_torch.core import load_config_dict
    from unav_yolyolva_tpu_torch.data.synthetic import make_synthetic_dataset

    synth = make_synthetic_dataset(str(root), num_videos=num_videos, num_classes=num_classes,
                                   min_len=40, max_len=max_len, visual_dim=64, audio_dim=16,
                                   seed=11, events_per_video=2, val_fraction=1.0)
    cfg = load_config_dict({
        "test_split": ["validation"],
        "dataset": {"json_file": synth["json_file"], "feat_folder": synth["feat_folder"],
                    "num_classes": num_classes, "max_seq_len": max_len, "max_num_events": 8},
        "loader": {"batch_size": 4, "num_workers": 2, "prefetch": 2},
        "model": {"raw_input_dim_V": 64, "raw_input_dim_A": 16, "input_dim_V": 32,
                  "input_dim_A": 32, "embd_dim": 32, "head_dim": 32, "use_abs_pe": True,
                  "class_aware": True},
        "test_cfg": {"pre_nms_topk": 100, "max_seg_num": 20, "min_score": 0.001,
                     "nms_sigma": 0.4, "iou_threshold": 0.7},
    })
    return synth, cfg


def test_cuda_batcher_yields_pinned_tensors(cuda, tmp_path):
    """Every array of a CUDA batch is a page-locked tensor holding the CPU
    Batcher's numpy array."""
    from unav_yolyolva_tpu_torch.data import UnAV100Dataset, make_batcher

    _, cfg = _files(tmp_path)
    ds = UnAV100Dataset(False, cfg["test_split"], **cfg["dataset"])
    with make_batcher(ds, cfg, False, device=cuda) as b:
        pinned = list(b)
    with make_batcher(ds, cfg, False, device="cpu") as b:
        plain = list(b)
    assert len(pinned) == len(plain) == 4
    for p, n in zip(pinned, plain):
        assert p["video_id"] == n["video_id"]
        for k, v in n.items():
            if k == "video_id":
                continue
            assert isinstance(p[k], torch.Tensor) and p[k].is_pinned(), k
            np.testing.assert_array_equal(p[k].numpy(), v, err_msg=k)


def test_host_allocator_keeps_a_block_until_its_copy_ran(cuda):
    """The premise of the pinned pipeline: a pinned block whose
    non_blocking copy is still queued is not handed out again."""
    side = torch.cuda.Stream()
    src = torch.empty(1 << 22, pin_memory=True).fill_(1.0)
    dst = torch.empty(1 << 22, device=cuda)
    ptr = src.data_ptr()
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)                 # the copy waits behind this
        dst.copy_(src, non_blocking=True)
    del src
    again = torch.empty(1 << 22, pin_memory=True)
    assert again.data_ptr() != ptr
    torch.cuda.synchronize()
    assert bool((dst == 1.0).all())


def test_eval_step_pinned_batches_give_the_numpy_batches_bits(cuda, tmp_path):
    """Four batches dispatched back to back from the pinned Batcher (two
    prefetched while the first computes) give the bits of the same batches
    fed as pageable numpy arrays: no pinned buffer is reused in flight."""
    from unav_yolyolva_tpu_torch.data import UnAV100Dataset, make_batcher
    from unav_yolyolva_tpu_torch.eval import make_eval_step
    from unav_yolyolva_tpu_torch.models import build_model

    _, cfg = _files(tmp_path)
    ds = UnAV100Dataset(False, cfg["test_split"], **cfg["dataset"])
    step = make_eval_step(build_model(cfg, device=cuda, seed=0), cfg, device=cuda)
    with make_batcher(ds, cfg, False, device=cuda) as pb, \
            make_batcher(ds, cfg, False, device="cpu") as nb:
        for _ in range(2):
            piped = [step(b) for b in pb]
            plain = [step(b) for b in nb]
            torch.cuda.synchronize()
            assert len(piped) == len(plain) == 4
            for p, n in zip(piped, plain):
                for k in n:
                    assert torch.equal(p[k], n[k]), k


def test_valid_one_epoch_cuda_gives_the_cpu_map(cuda, tmp_path):
    """valid_one_epoch through the pinned Batcher on the card returns the
    CPU path's mAP at the golden width (tests/_golden_common.py)."""
    import copy

    from unav_yolyolva_tpu_torch.data import UnAV100Dataset, make_batcher
    from unav_yolyolva_tpu_torch.eval import make_eval_step
    from unav_yolyolva_tpu_torch.eval.metrics import ANETdetection
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.train import valid_one_epoch

    synth, cfg = _files(tmp_path, num_videos=8, num_classes=5, max_len=64)
    ds = UnAV100Dataset(False, cfg["test_split"], **cfg["dataset"])
    ev = ANETdetection(synth["json_file"], "validation", tiou_thresholds=np.linspace(0.1, 0.9, 9))
    maps = []
    model = build_model(cfg, device=cuda, seed=0)
    for dev, m in ((cuda, model), ("cpu", copy.deepcopy(model).cpu())):
        with make_batcher(ds, cfg, False, device=dev) as b:
            maps.append(valid_one_epoch(m, b, make_eval_step(m, cfg, device=dev), -1,
                                        evaluator=ev)[0])
    assert np.isfinite(maps[0]) and 0 <= maps[0] <= 1
    assert abs(maps[0] - maps[1]) <= 1e-6, maps


# ---- the dependency block's shapes: one head of width 128 ----------------------

def _dependency_rows(gen, cuda, r, t):
    """(x1, x2, mask) of r rows of length t, as the co-occurrence branch
    gives them: every third row fully masked (a padded frame), the others
    full or partly masked."""
    lengths = [0 if i % 3 == 1 else (t if i % 3 == 0 else max(1, t - 7 * i)) for i in range(r)]
    x1, x2 = torch.randn(r, t, 128, generator=gen), torch.randn(r, t, 128, generator=gen)
    return x1.to(cuda), x2.to(cuda), _mask(r, t, lengths, cuda)


@pytest.mark.parametrize("t", [100, 224])
def test_mhca_one_head_of_128_with_fully_masked_rows(cuda, t):
    """Forward and backward at C = 128 with one head: fully masked rows give
    exact zeros (output and input grads), weight grads stay finite, and two
    runs give the same bits."""
    from unav_yolyolva_tpu_torch.ops.fused_mhca import (fused_mhca, mhca_backward,
                                                        mhca_backward_reference,
                                                        mhca_reference)

    gen = torch.Generator().manual_seed(21)
    x1, x2, mask = _dependency_rows(gen, cuda, 24, t)
    ws = [w.to(cuda) for w in _mhca_weights(128, gen, cuda)]
    dead = ~mask.any(1)
    out = fused_mhca(x1, x2, mask, *ws, heads=1)
    again = fused_mhca(x1, x2, mask, *ws, heads=1)
    ref = mhca_reference(x1, x2, mask, *ws, heads=1)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
    assert torch.equal(out, again) and (out[dead] == 0).all() and int(dead.sum()) == 8
    g = torch.randn(x1.shape, generator=gen).to(cuda)
    got = mhca_backward(x1, x2, mask, *ws, g, heads=1)
    got2 = mhca_backward(x1, x2, mask, *ws, g, heads=1)
    ref = mhca_backward_reference(x1, x2, mask, *ws, g, heads=1)
    torch.cuda.synchronize()
    _check_grads(got, ref, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, got2)), "not deterministic"
    assert (got[0][dead] == 0).all() and (got[1][dead] == 0).all()
    assert all(bool(torch.isfinite(w).all()) for w in got[2:])


@pytest.mark.parametrize("t", [100, 224])
def test_tblock_kernel_at_hidden_c(cuda, t):
    """The whole block at hidden = C = 128, one head (the dependency
    block's), forward and backward, with fully masked rows."""
    from unav_yolyolva_tpu_torch.ops.fused_tblock import (fused_tblock, tblock_backward,
                                                          tblock_backward_reference,
                                                          tblock_reference)

    gen = torch.Generator().manual_seed(22)
    lengths = [t, 0, t - 9, 0, 5, t]
    args = _tblock_args(gen, cuda, 6, t, 128, 1, lengths, hid=128)
    assert args[11].shape == (128, 128)
    out = fused_tblock(*args, heads=1)
    ref = tblock_reference(*args, heads=1)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)
    assert (out[1] == 0).all() and (out[3] == 0).all()
    g = torch.randn(args[0].shape, generator=gen).to(cuda)
    got = tblock_backward(*args, g=g, heads=1)
    again = tblock_backward(*args, g=g, heads=1)
    ref = tblock_backward_reference(*args, g=g, heads=1)
    torch.cuda.synchronize()
    _check_grads(got, ref, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "not deterministic"
    assert (got[0][1] == 0).all() and (got[0][3] == 0).all()


# ---- the dependency block's k=3 convs on wgmma (ops/conv3_tc.py) -------------------

# (name, Kc, N, relu) of the block's two convs at the published widths
_DEP_CONVS = {"expand": (1024, 12800, True), "squeeze": (12800, 1024, False)}


def _conv3_case(gen, cuda, b, t, kc, n):
    """x (b, t, kc), the conv's weight (n, kc, 3), a mask with the first row
    full, the last padded to a third and one row empty."""
    x = torch.randn(b, t, kc, generator=gen).to(cuda)
    w = (torch.randn(n, kc, 3, generator=gen) / (3 * kc) ** 0.5).to(cuda)
    lengths = [t] + [max(1, (t * (i + 1)) // b) for i in range(1, b - 2)] + [0, max(1, t // 3)]
    return x, w, _mask(b, t, lengths[:b], cuda)


def _conv3_fp64(x, w, mask, relu):
    from unav_yolyolva_tpu_torch.ops.gemm_tc import conv3_taps

    b, t, kc = x.shape
    y = conv3_taps(x.reshape(b * t, kc).double(), t) @ w.double().permute(0, 2, 1).reshape(
        w.shape[0], -1).T
    return ((y.clamp_min(0) if relu else y) * mask.reshape(-1, 1)).reshape(b, t, -1)


@pytest.mark.parametrize("level", range(6))
@pytest.mark.parametrize("conv", ["expand", "squeeze"])
def test_masked_conv3_against_fp64_at_the_blocks_shapes(cuda, conv, level):
    """Each level's shape of both convs at B=64 (T = 224 >> level): the
    kernel's norm-wise error against fp64 within 2x that of cuDNN's fp32
    conv (TF32 off), masked rows exactly 0, the same bits on repeat, one
    launch a call; at levels 3-5 also within rtol 1e-3 / atol 1e-4 of the
    plain version."""
    import torch.nn.functional as F

    from unav_yolyolva_tpu_torch.ops.conv3_tc import masked_conv3, masked_conv3_reference

    kc, n, relu = _DEP_CONVS[conv]
    gen = torch.Generator().manual_seed(40 + level)
    x, w, mask = _conv3_case(gen, cuda, 64, 224 >> level, kc, n)
    before = masked_conv3.launches
    y = masked_conv3([x], w, [mask], relu=relu)[0]
    again = masked_conv3([x], w, [mask], relu=relu)[0]
    torch.cuda.synchronize()
    assert masked_conv3.launches == before + 2
    ref = _conv3_fp64(x, w, mask, relu)
    y32 = F.conv1d(x.transpose(1, 2), w, padding=1).transpose(1, 2)
    y32 = (y32.clamp_min(0) if relu else y32) * mask[..., None]
    err = float((y.double() - ref).norm() / ref.norm())
    err32 = float((y32.double() - ref).norm() / ref.norm())
    assert err <= 2 * err32, f"3xTF32 error {err:.3e} vs fp32 conv {err32:.3e}"
    assert torch.equal(y, again), "not bit-identical on repeat"
    assert bool((y[~mask] == 0).all())
    if level >= 3:
        torch.testing.assert_close(y, masked_conv3_reference(x, w, mask, relu), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("conv", ["expand", "squeeze"])
def test_masked_conv3_bits_independent_of_the_levels_of_a_launch(cuda, conv):
    """The six levels of a batch of 64 in one launch, one launch a level,
    and levels 1-5 in reverse order with level 0 left out: the same bits."""
    from unav_yolyolva_tpu_torch.ops.conv3_tc import conv3_split, masked_conv3

    kc, n, relu = _DEP_CONVS[conv]
    gen = torch.Generator().manual_seed(47)
    w = (torch.randn(n, kc, 3, generator=gen) / (3 * kc) ** 0.5).to(cuda)
    cases = [_conv3_case(gen, cuda, 64, 224 >> lv, kc, 8) for lv in range(6)]
    xs, masks = [c[0] for c in cases], [c[2] for c in cases]
    split = conv3_split(w)
    together = masked_conv3(xs, w, masks, relu=relu, split=split)
    alone = [masked_conv3([x], w, [m], relu=relu, split=split)[0] for x, m in zip(xs, masks)]
    rest = masked_conv3(xs[:0:-1], w, masks[:0:-1], relu=relu, split=split)[::-1]
    torch.cuda.synchronize()
    for lv in range(6):
        assert torch.equal(together[lv], alone[lv]), lv
        if lv:
            assert torch.equal(together[lv], rest[lv - 1]), lv


@pytest.mark.parametrize("relu", [True, False])
def test_masked_conv3_grads_against_fp64(cuda, relu):
    """Two levels sharing the weight (T = 40 and 7): the autograd Function's
    input grads and summed weight grad (the 3xTF32 A.B and A^T.B products,
    no cuDNN) against autograd of the fp64 conv, norm-wise within 1e-4;
    the same bits on repeat."""
    from unav_yolyolva_tpu_torch.ops.conv3_tc import masked_conv3

    gen = torch.Generator().manual_seed(48)
    (x1, w, m1), (x2, _, m2) = (_conv3_case(gen, cuda, 4, 40, 256, 384),
                                _conv3_case(gen, cuda, 4, 7, 256, 384))
    gs = [torch.randn(4, t, 384, generator=gen).to(cuda) for t in (40, 7)]

    def grads():
        xs = [x.clone().requires_grad_(True) for x in (x1, x2)]
        wg = w.clone().requires_grad_(True)
        torch.autograd.backward(masked_conv3(xs, wg, [m1, m2], relu=relu), gs)
        return [xs[0].grad, xs[1].grad, wg.grad]

    got, again = grads(), grads()
    xr = [x.double().requires_grad_(True) for x in (x1, x2)]
    wr = w.double().requires_grad_(True)
    torch.autograd.backward([_conv3_fp64(x, wr, m, relu) for x, m in zip(xr, (m1, m2))],
                            [g.double() for g in gs])
    for k, r in zip(got, [xr[0].grad, xr[1].grad, wr.grad]):
        assert float((k.double() - r).norm() / r.norm()) <= 1e-4
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "not deterministic"


def test_masked_conv3_refuses_what_it_does_not_take(cuda):
    """Unaligned or non-contiguous x, Kc off 4 floats, bf16 x, a mask that is
    not a contiguous bool (B, T), seven levels, halves of another shape."""
    from unav_yolyolva_tpu_torch.ops.conv3_tc import conv3_split, masked_conv3

    gen = torch.Generator().manual_seed(49)
    x, w, mask = _conv3_case(gen, cuda, 4, 14, 64, 32)
    split = conv3_split(w)
    wide = torch.randn(4, 14, 65, generator=gen).to(cuda)
    bad = [
        ([wide[..., 1:]], [mask], split),                                 # unaligned, strided
        ([x.transpose(0, 1).contiguous().transpose(0, 1)], [mask], split),  # non-contiguous
        ([x.to(torch.bfloat16)], [mask], split),
        ([x], [mask.int()], split),
        ([x], [torch.ones(4, 28, dtype=torch.bool, device=cuda)[:, ::2]], split),
        ([x] * 7, [mask] * 7, split),
        ([x], [mask], (split[0][:, :, :60].contiguous(), split[1][:, :, :60].contiguous())),
    ]
    before = masked_conv3.launches
    for xs, masks, sp in bad:
        with pytest.raises(ValueError):
            masked_conv3(xs, w, masks, relu=True, split=sp)
    with pytest.raises(ValueError):       # Kc off 4 floats
        wk = (torch.randn(32, 6, 3, generator=gen)).to(cuda)
        masked_conv3([torch.randn(4, 14, 6, generator=gen).to(cuda)], wk, [mask], relu=True)
    assert masked_conv3.launches == before


def _dependency_kernels(prof):
    """Names of the kernels launched on the main thread inside a
    `unav.dependency.expand` or `.squeeze` span of a torch.profiler run."""
    events = list(prof.events())
    spans = [(e.time_range.start, e.time_range.end, e.thread) for e in events
             if e.device_type.name == "CPU"
             and e.name in ("unav.dependency.expand", "unav.dependency.squeeze")]
    launched = {e.id for e in events if e.device_type.name == "CPU" and e.name.startswith("cu")
                and any(a <= e.time_range.start <= b and e.thread == th for a, b, th in spans)}
    return [e.name for e in events if e.device_type.name == "CUDA" and e.id in launched
            and not e.name.startswith(("Memcpy", "Memset", "unav."))]


def test_dependency_block_serves_its_convs_on_the_tensor_core_kernel(cuda):
    """A served batch of 64 at the published widths with the block: 7
    launches of the conv kernel (the expanding conv at each of the 6
    levels, the squeezing conv over all 6 in one), 2 weight splits, and no
    cuDNN convolution under the block's `unav.dependency.expand` or
    `.squeeze` spans."""
    from torch.profiler import ProfilerActivity, profile

    from unav_yolyolva_tpu_torch.data.synthetic import synthetic_eval_batch
    from unav_yolyolva_tpu_torch.eval import make_eval_step
    from unav_yolyolva_tpu_torch.eval.step import fetch_detections
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.ops.conv3_tc import masked_conv3

    cfg = _dependency_cfg()
    m = cfg["model"]
    step = make_eval_step(build_model(cfg, device=cuda, seed=0), cfg, cuda)
    batch = synthetic_eval_batch(torch.Generator().manual_seed(25), 64, m["max_seq_len"],
                                 m["raw_input_dim_V"], m["raw_input_dim_A"])
    fetch_detections(step(batch))
    torch.cuda.synchronize()
    before = masked_conv3.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, done = fetch_detections(step(batch))
        if done is not None:
            done.synchronize()
        torch.cuda.synchronize()
    assert masked_conv3.launches - before == 7
    names = _dependency_kernels(prof)
    assert sum("conv3_tc_kernel" in k for k in names) == 7
    assert sum("conv3_split_kernel" in k for k in names) == 2
    conv = [k for k in names if any(s in k.lower() for s in ("conv", "xmma", "cudnn", "implicit"))
            and "conv3_" not in k]
    assert not conv, conv


def test_train_step_pinned_batches_give_the_pageable_losses(cuda, tmp_path):
    """Four train batches from the pinned Batcher, dispatched back to back
    (the copy stream of the train step), give the losses of the same batches
    fed as pageable numpy arrays to a second, identical state."""
    from unav_yolyolva_tpu_torch.core import load_config_dict
    from unav_yolyolva_tpu_torch.data import UnAV100Dataset, make_batcher
    from unav_yolyolva_tpu_torch.data.synthetic import make_synthetic_dataset
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.train import (create_train_state, make_optimizer,
                                               make_train_step)

    synth = make_synthetic_dataset(str(tmp_path), num_videos=16, num_classes=5, min_len=40,
                                   max_len=64, visual_dim=64, audio_dim=16, seed=11,
                                   events_per_video=2, val_fraction=0.0)
    cfg = load_config_dict({
        "train_split": ["train"],
        "dataset": {"json_file": synth["json_file"], "feat_folder": synth["feat_folder"],
                    "num_classes": 5, "max_seq_len": 64, "max_num_events": 8},
        "loader": {"batch_size": 4, "num_workers": 2, "prefetch": 2},
        "model": {"raw_input_dim_V": 64, "raw_input_dim_A": 16, "input_dim_V": 32,
                  "input_dim_A": 32, "embd_dim": 32, "head_dim": 32, "use_abs_pe": True,
                  "class_aware": True},
        "opt": {"learning_rate": 1e-3, "epochs": 2, "warmup_epochs": 1},
    })
    ds = UnAV100Dataset(True, cfg["train_split"], **cfg["dataset"])
    losses = {}
    # cuDNN's deterministic algorithms, as the train CLI sets them: its
    # default weight-grad algorithms sum in a varying order
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for dev in ("pinned", "cpu"):
        model = build_model(cfg, device=cuda, seed=0)
        opt, _ = make_optimizer(model, cfg["opt"], 4)
        state = create_train_state(model, opt, 100.0)
        step = make_train_step(model, opt, cfg, device=cuda)
        out = []
        with make_batcher(ds, cfg, True, seed=5, device=cuda if dev == "pinned" else "cpu") as b:
            for bt in b:
                pinned = isinstance(bt["visual"], torch.Tensor) and bt["visual"].is_pinned()
                assert pinned == (dev == "pinned")
                out.append(step(state, bt, 3))
        torch.cuda.synchronize()
        losses[dev] = [{k: float(v) for k, v in o.items()} for o in out]
    torch.backends.cudnn.deterministic = deterministic
    assert len(losses["pinned"]) == 4
    for p, n in zip(losses["pinned"], losses["cpu"]):
        assert p == n


# ---- the bf16 compute policy's kernels (csrc/bf16.cuh) -------------------------
#
# Each bf16 kernel against its plain version on the same bf16 inputs: their
# fp32 sums are taken in another order, so a few values round to the other
# bf16 neighbour; held norm-wise (<= 8e-3), and each one's error against the
# fp32 plain version of the same (bf16-valued) inputs within 1.25x of the
# other's. Two runs of a kernel give the same bits.

BF16_TOL = 8e-3


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp(min=1e-30))


def _bf16_vs_plain(name, run, plain, plain32):
    out, again, ref, ref32 = run(), run(), plain(), plain32()
    torch.cuda.synchronize()
    assert out.dtype == ref.dtype and torch.isfinite(out).all()
    assert torch.equal(out, again), f"{name}: two runs of the bf16 kernel differ"
    err, ek, ep = _rel(out, ref), _rel(out, ref32), _rel(ref, ref32)
    assert err <= BF16_TOL, f"{name}: kernel vs plain {err:.3e}"
    assert ek <= 1.25 * ep and ep <= 1.25 * ek, f"{name}: vs fp32 kernel {ek:.3e}, plain {ep:.3e}"
    return out


@pytest.mark.parametrize("case", ["plain", "conv_bias_mask", "gelu_scale", "tail", "raw"])
def test_bf16_product_against_plain_and_fp64(cuda, case):
    from unav_yolyolva_tpu_torch.ops.gemm_tc import bf16_product_reference, bf16_products

    gen = torch.Generator().manual_seed(40)
    bf = torch.bfloat16
    m, n, kc, seq = 100, 72, 96, 20
    taps = 3 if case == "conv_bias_mask" else 1
    x = torch.randn(m, kc, generator=gen).to(cuda, bf)
    w = (torch.randn(n, taps * kc, generator=gen) / (taps * kc) ** 0.5).to(cuda, bf)
    call = dict(x=x, w=w)
    if case == "conv_bias_mask":
        call.update(taps=3, seq=seq, bias=(0.1 * torch.randn(n, generator=gen)).to(cuda, bf),
                    rowmask=_mask(m // seq, seq, [seq, 7, 0, 20, 3], cuda).reshape(m))
    elif case == "gelu_scale":
        call.update(act="gelu", scale=0.3, bias=(0.1 * torch.randn(n, generator=gen)).to(cuda, bf))
    elif case == "tail":
        call.update(seq=seq, seqmul=(1 + 0.3 * torch.randn(m // seq, n, generator=gen)).to(cuda),
                    out=torch.randn(m, n, generator=gen).to(cuda),
                    rowmask=_mask(m // seq, seq, [seq, 7, 0, 20, 3], cuda).reshape(m))
    elif case == "raw":
        call.update(raw=True)
    start = call["out"].clone() if "out" in call else None

    def run():
        if start is not None:
            call["out"].copy_(start)
        return bf16_products([call])[0].clone()

    def plain(**kw):
        c = dict(call, out=start, **kw)
        return bf16_product_reference(c.pop("x"), c.pop("w"), c.pop("bias", None), **c)

    out, again = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    ref = plain()
    if case == "raw":
        # the fp32 sums of the bf16 operands against fp64: within 2x the error
        # of fp32 torch.matmul of the same operands (TF32 off)
        ref64 = x.double() @ w.double().T
        err_k = _rel(out, ref64)
        err_32 = _rel(x.float() @ w.float().T, ref64)
        assert err_k <= 2 * err_32, f"bf16 product sums {err_k:.3e} vs fp32 matmul {err_32:.3e}"
    else:
        assert out.dtype == ref.dtype
        assert _rel(out, ref) <= BF16_TOL
        assert (out != ref).float().mean() <= 0.01   # only rounding flips


@pytest.mark.parametrize("t,c,heads", [(40, 64, 4), (7, 128, 4), (64, 96, 3), (130, 256, 2)])
def test_bf16_mhca_kernel(cuda, t, c, heads):
    from unav_yolyolva_tpu_torch.ops.fused_mhca import fused_mhca, mhca_reference

    gen = torch.Generator().manual_seed(41)
    b = 3
    x1 = torch.randn(b, t, c, generator=gen).to(cuda, torch.bfloat16)
    x2 = torch.randn(b, t, c, generator=gen).to(cuda, torch.bfloat16)
    ws = [w.to(cuda) for w in _mhca_weights(c, gen, cuda)]
    mask = _mask(b, t, [t, t // 2, 0], cuda)
    before = fused_mhca.bf16_launches
    out = _bf16_vs_plain(
        f"mhca_bf16 {t}x{c}/{heads}", lambda: fused_mhca(x1, x2, mask, *ws, heads=heads),
        lambda: mhca_reference(x1, x2, mask, *ws, heads=heads),
        lambda: mhca_reference(x1.float(), x2.float(), mask, *ws, heads=heads))
    assert fused_mhca.bf16_launches == before + 2
    assert (out[2] == 0).all()


def _bf16_csp_args(gen, cuda, b, t, heads, cin=128, mid=64, ng=40, fg=24):
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
    args = [a.to(cuda) if a is not None else _mask(b, t, [t, 3, t - 1][:b], cuda) for a in args]
    args[0], args[1] = args[0].bfloat16(), args[1].bfloat16()
    return args


@pytest.mark.parametrize("t,heads", [(7, 4), (20, 8), (130, 4)])
def test_bf16_csp_kernel(cuda, t, heads):
    from unav_yolyolva_tpu_torch.ops.fused_csp import csp_reference, fused_csp

    gen = torch.Generator().manual_seed(42)
    args = _bf16_csp_args(gen, cuda, 3, t, heads)
    f32 = [args[0].float(), args[1].float(), *args[2:]]
    before = fused_csp.bf16_launches
    _bf16_vs_plain(f"csp_bf16 T{t}/{heads}", lambda: fused_csp(*args, attn_heads=heads),
                   lambda: csp_reference(*args, attn_heads=heads),
                   lambda: csp_reference(*f32, attn_heads=heads))
    assert fused_csp.bf16_launches == before + 2


@pytest.mark.parametrize("r,t,c,heads", [(3, 40, 64, 4), (3, 7, 128, 4), (3, 130, 96, 3)])
def test_bf16_tblock_kernel(cuda, r, t, c, heads):
    from unav_yolyolva_tpu_torch.ops.fused_tblock import fused_tblock, tblock_reference

    gen = torch.Generator().manual_seed(43)
    a = _tblock_args(gen, cuda, r, t, c, heads, [t, t // 2, 0])
    before = fused_tblock.bf16_launches
    out = _bf16_vs_plain(
        f"tblock_bf16 {r}x{t}x{c}",
        lambda: fused_tblock(*a, heads=heads, cdtype=torch.bfloat16),
        lambda: tblock_reference(*a, heads=heads, cdtype=torch.bfloat16),
        lambda: tblock_reference(*a, heads=heads))
    assert out.dtype == torch.float32 and fused_tblock.bf16_launches == before + 2


@pytest.mark.parametrize("layout,a_f32,kblock,round_blocks",
                         [("nt", False, None, False), ("nn", False, None, False),
                          ("nn", True, None, False), ("tn", False, 48, True),
                          ("tn", True, 100, False), ("tn", False, None, False)])
def test_bf16_backward_product_layouts(cuda, layout, a_f32, kblock, round_blocks):
    """The backward's strided bf16 product in each layout against its plain
    version: fp32 sums within 1e-5 of the sum of the products' magnitudes
    (both add exact products in fp32, in other orders: K = 200 roundings of
    ~6e-8 at most), so rounded weight grads agree but where a sum sits on a
    bf16 rounding edge; the bf16 output a rounding flip apart at most, on at
    most 1% of the elements."""
    from unav_yolyolva_tpu_torch.ops.gemm_tc import bf16_layout_product, bf16_layout_reference

    gen = torch.Generator().manual_seed(49)
    m, n, k = 70, 56, 200
    a = torch.randn(*((k, m) if layout == "tn" else (m, k)), generator=gen).to(cuda)
    if not a_f32:
        a = a.bfloat16()
    b = (torch.randn(*((n, k) if layout == "nt" else (k, n)), generator=gen) / k ** 0.5).to(
        cuda, torch.bfloat16)
    kw = dict(kblock=kblock, round_blocks=round_blocks)
    out32 = bf16_layout_product(a, b, layout, out_bf16=False, **kw)
    again = bf16_layout_product(a, b, layout, out_bf16=False, **kw)
    ref32 = bf16_layout_reference(a, b, layout, out_bf16=False, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out32, again)
    if round_blocks:
        assert (out32 != ref32).float().mean() <= 0.01
        assert _rel(out32, ref32) <= BF16_TOL
    else:
        mag = bf16_layout_reference(a.abs(), b.abs(), layout, out_bf16=False, **kw)
        assert ((out32 - ref32).abs() <= 1e-5 * mag).all()
    y = bf16_layout_product(a, b, layout, scale=0.5, **kw)
    yr = bf16_layout_reference(a, b, layout, scale=0.5, **kw)
    assert y.dtype == torch.bfloat16 and (y != yr).float().mean() <= 0.01
    assert _rel(y, yr) <= BF16_TOL


def _bf16_grads_vs_plain(name, run, plain, plain32, moved):
    """Every grad of a bf16 backward kernel against its plain version: the
    same dtype, finite, the same bits on repeat, norm-wise within 1/4 of the
    plain version's own gap to the fp32 plain version; or, where the two
    programs' fp32 sums round a bf16 value apart and the flip spreads,
    within 2x the kernel's own move when one input value of each row moves
    by one bf16 ulp (`moved(sign)`, the larger of up and down), as
    chip_smoke.py:check_bf16_grads holds it."""
    got, again, ref, ref32 = run(), run(), plain(), plain32()
    ups, downs = moved(1), moved(-1)
    torch.cuda.synchronize()
    for i, (k, k2, p, p32) in enumerate(zip(got, again, ref, ref32)):
        assert k.dtype == p.dtype and torch.isfinite(k).all(), (name, i)
        assert torch.equal(k, k2), f"{name} grad {i}: two runs differ"
        err, gap = _rel(k, p), _rel(p, p32)
        move = max(_rel(ups[i], k), _rel(downs[i], k))
        assert err <= 0.25 * gap or err <= 2 * move, (
            f"{name} grad {i}: kernel vs plain {err:.3e}, plain vs fp32 {gap:.3e}, the "
            f"kernel's one-ulp move {move:.3e}")
    return got


def _bump(x, mask, gen):
    from unav_yolyolva_tpu_torch.tools.grad_gaps import ulp_bump

    return lambda sign: ulp_bump(x, mask, gen, sign)


@pytest.mark.parametrize("cross", [True, False])
def test_bf16_mhca_backward_kernel(cuda, cross):
    from unav_yolyolva_tpu_torch.ops.fused_mhca import mhca_backward, mhca_backward_reference

    gen = torch.Generator().manual_seed(46)
    b, t, c, heads = 3, 16, 64, 4
    x1 = torch.randn(b, t, c, generator=gen).to(cuda, torch.bfloat16)
    x2 = torch.randn(b, t, c, generator=gen).to(cuda, torch.bfloat16) if cross else x1
    g = torch.randn(b, t, c, generator=gen).to(cuda, torch.bfloat16)
    ws = [w.to(cuda) for w in _mhca_weights(c, gen, cuda)]
    mask = _mask(b, t, [t, 9, 0], cuda)
    bump = _bump(x1, mask, gen)

    def moved(sign):
        xb = bump(sign)
        return mhca_backward(xb, xb if x2 is x1 else x2, mask, *ws, g, heads=heads)

    before = mhca_backward.bf16_launches
    got = _bf16_grads_vs_plain(
        "mhca_bwd_bf16", lambda: mhca_backward(x1, x2, mask, *ws, g, heads=heads),
        lambda: mhca_backward_reference(x1, x2, mask, *ws, g, heads=heads),
        lambda: mhca_backward_reference(x1.float(), x2.float(), mask, *ws, g.float(),
                                        heads=heads), moved)
    assert mhca_backward.bf16_launches == before + 4
    assert (got[0][2] == 0).all() and (got[1][2] == 0).all()


@pytest.mark.parametrize("t,heads", [(16, 4), (7, 8)])
def test_bf16_csp_backward_kernel(cuda, t, heads):
    from unav_yolyolva_tpu_torch.ops.fused_csp import csp_backward, csp_backward_reference

    gen = torch.Generator().manual_seed(47)
    args = _bf16_csp_args(gen, cuda, 3, t, heads)
    g = torch.randn(3, t, 128, generator=gen).to(cuda, torch.bfloat16)
    f32 = [args[0].float(), args[1].float(), *args[2:]]
    bump = _bump(args[0], args[2], gen)
    before = csp_backward.bf16_launches
    _bf16_grads_vs_plain(
        f"csp_bwd_bf16 T{t}", lambda: csp_backward(*args, g=g, attn_heads=heads),
        lambda: csp_backward_reference(*args, g=g, attn_heads=heads),
        lambda: csp_backward_reference(*f32, g=g.float(), attn_heads=heads),
        lambda sign: csp_backward(bump(sign), *args[1:], g=g, attn_heads=heads))
    assert csp_backward.bf16_launches == before + 4


def test_bf16_tblock_backward_kernel(cuda):
    from unav_yolyolva_tpu_torch.ops.fused_tblock import (tblock_backward,
                                                          tblock_backward_reference)

    gen = torch.Generator().manual_seed(48)
    a = _tblock_args(gen, cuda, 3, 16, 64, 4, [16, 9, 0])
    g = torch.randn(3, 16, 64, generator=gen).to(cuda)
    bump = _bump(a[0], a[1], gen)
    before = tblock_backward.bf16_launches
    _bf16_grads_vs_plain(
        "tblock_bwd_bf16", lambda: tblock_backward(*a, g=g, heads=4, cdtype=torch.bfloat16),
        lambda: tblock_backward_reference(*a, g=g, heads=4, cdtype=torch.bfloat16),
        lambda: tblock_backward_reference(*a, g=g, heads=4),
        lambda sign: tblock_backward(bump(sign), *a[1:], g=g, heads=4,
                                     cdtype=torch.bfloat16))
    assert tblock_backward.bf16_launches == before + 4


@pytest.mark.parametrize("which", ["csp", "tblock"])
def test_bf16_backward_kernels_follow_the_row_blocks(cuda, monkeypatch, which):
    """With the port's copy of the JAX row picker at 1 (3 blocks of a row
    where it picks one of 3 rows), as chip_smoke.py:check_row_blocks holds
    it: the kernel's input grads do not move; each weight grad that the
    plain version on the CPU moves (the JAX program rounds it per block) the
    kernel moves by as much (within 2x either way), and by the same amounts
    (the difference within 1/4) where the two agree bit for bit on the input
    grads; the grads the plain version leaves in place (fp32 sums) the
    kernel moves by 1e-5 at most."""
    from unav_yolyolva_tpu_torch.ops import fused_csp, fused_tblock

    gen = torch.Generator().manual_seed(50)
    if which == "csp":
        args = _bf16_csp_args(gen, cuda, 3, 16, 4)
        g = torch.randn(3, 16, 128, generator=gen).to(cuda, torch.bfloat16)
        kernel = lambda: fused_csp.csp_backward(*args, g=g, attn_heads=4)
        plain = lambda: fused_csp.csp_backward_reference(*[a.cpu() for a in args], g=g.cpu(),
                                                         attn_heads=4)
        module, picker, n_in, first = fused_csp, "pick_rows_csp_bwd", 2, 2
        assert fused_csp.csp_backward_rows(*args, attn_heads=4) == 3
    else:
        a = _tblock_args(gen, cuda, 3, 16, 64, 4, [16, 9, 0])
        g = torch.randn(3, 16, 64, generator=gen).to(cuda)
        kernel = lambda: fused_tblock.tblock_backward(*a, g=g, heads=4, cdtype=torch.bfloat16)
        plain = lambda: fused_tblock.tblock_backward_reference(
            *[v.cpu() for v in a], g=g.cpu(), heads=4, cdtype=torch.bfloat16)
        module, picker, n_in, first = fused_tblock, "pick_rows_tb_bwd", 1, 3
        assert fused_tblock.tblock_backward_rows(a[0], *a[4:], heads=4) == 3
    base_k, base_p = kernel(), plain()
    monkeypatch.setattr(module, picker, lambda *a, **k: 1)
    k1, p1 = kernel(), plain()
    assert all(torch.equal(k1[i], base_k[i]) for i in range(n_in))
    exact = all(torch.equal(base_k[i].cpu(), base_p[i]) for i in range(n_in))
    moved = 0
    for i in range(first, len(p1)):
        norm = float(p1[i].double().norm())
        dp = p1[i].double() - base_p[i].double()
        dk = (k1[i].double() - base_k[i].double()).cpu()
        if float(dp.norm()) > 1e-5 * norm:
            moved += 1
            assert 0.5 <= float(dk.norm()) / float(dp.norm()) <= 2, (which, i)
            assert not exact or float((dk - dp).norm()) <= 0.25 * float(dp.norm()), (which, i)
        else:
            assert float(dk.norm()) <= 1e-5 * norm, (which, i)
    assert moved >= 4, (which, moved)


def test_bf16_grads_run_the_bf16_backward_kernels(cuda):
    """A bf16 CUDA call that needs a grad goes through its Function: the
    backward launches the bf16 backward kernel, never the fp32 one."""
    from unav_yolyolva_tpu_torch.ops.fused_csp import csp_backward, fused_csp
    from unav_yolyolva_tpu_torch.ops.fused_mhca import fused_mhca, mhca_backward
    from unav_yolyolva_tpu_torch.ops.fused_tblock import fused_tblock, tblock_backward

    gen = torch.Generator().manual_seed(44)
    c, t = 64, 16
    counts = lambda: (mhca_backward.launches, csp_backward.launches, tblock_backward.launches,
                      mhca_backward.bf16_launches, csp_backward.bf16_launches,
                      tblock_backward.bf16_launches)
    before = counts()
    x = torch.randn(2, t, c, generator=gen).to(cuda, torch.bfloat16).requires_grad_(True)
    mask = _mask(2, t, [t, 5], cuda)
    ws = [w.to(cuda) for w in _mhca_weights(c, gen, cuda)]
    out = fused_mhca(x, x, mask, *ws, heads=4)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and torch.isfinite(x.grad.float()).all()
    a = _tblock_args(gen, cuda, 2, t, c, 4, [t, 5])
    xt = a[0].clone().requires_grad_(True)
    fused_tblock(xt, *a[1:], heads=4, cdtype=torch.bfloat16).sum().backward()
    assert xt.grad.dtype == torch.float32 and torch.isfinite(xt.grad).all()
    args = _bf16_csp_args(gen, cuda, 2, t, 4)
    xc = args[0].clone().requires_grad_(True)
    fused_csp(xc, *args[1:], attn_heads=4).float().sum().backward()
    assert xc.grad.dtype == torch.bfloat16 and torch.isfinite(xc.grad.float()).all()
    after = counts()
    assert after[:3] == before[:3]
    assert [a - b for a, b in zip(after[3:], before[3:])] == [1, 1, 1]


def test_bf16_wrappers_refuse_unaligned_widths(cuda):
    """bf16 rows of 16 bytes are 8 values: a head width of 4 is refused."""
    from unav_yolyolva_tpu_torch.ops.fused_mhca import fused_mhca

    gen = torch.Generator().manual_seed(45)
    x = torch.randn(2, 8, 16, generator=gen).to(cuda, torch.bfloat16)
    ws = [w.to(cuda) for w in _mhca_weights(16, gen, cuda)]
    with pytest.raises(ValueError, match="unsupported shape"):
        fused_mhca(x, x, _mask(2, 8, [8, 3], cuda), *ws, heads=4)


@pytest.mark.parametrize("vjp", [False, True])
@pytest.mark.parametrize("t,c,heads,lengths", [(100, 256, 4, [100, 57, 0]),
                                               (512, 256, 2, [512, 300, 1])])
def test_bf16_attention_backward_kernel(cuda, t, c, heads, lengths, vjp):
    """The fused bf16 attention backward (the MHCA backward's two attention
    launches) against its plain version under the bf16 backward kernels'
    rule, in the hand and the vjp form: several key tiles with masked keys,
    T not a multiple of the 32-row tile, a sequence without a valid key
    (exact zeros in dq, dk and dv), T = MAX_T = 512, head widths 64 and 128."""
    from unav_yolyolva_tpu_torch.ops.fused_mhca import (MAX_T, attention_backward,
                                                        attention_backward_reference)

    gen = torch.Generator().manual_seed(51)
    bf, r = torch.bfloat16, len(lengths)
    q = (torch.randn(r, t, c, generator=gen) * (c // heads) ** -0.5).to(cuda, bf)
    k, v, go = (torch.randn(r, t, c, generator=gen).to(cuda, bf) for _ in range(3))
    mask = _mask(r, t, lengths, cuda)
    bump = _bump(q, mask, gen)
    kw = dict(heads=heads, vjp=vjp)
    before = attention_backward.launches
    got = _bf16_grads_vs_plain(
        f"attention_backward T{t} d{c // heads} {'vjp' if vjp else 'hand'}",
        lambda: attention_backward(q, k, v, go, mask, **kw),
        lambda: attention_backward_reference(q, k, v, go, mask, **kw),
        lambda: attention_backward_reference(q, k, v, go, mask, rounded=False, **kw),
        lambda sign: attention_backward(bump(sign), k, v, go, mask, **kw))
    assert attention_backward.launches == before + 4 and t <= MAX_T
    for i, n in enumerate(lengths):
        assert (got[2][i, n:] == 0).all()                   # dv of the masked keys
        if n == 0:
            assert all((x[i] == 0).all() for x in got)


def test_bf16_csp_backward_launch_budget(cuda):
    """One bf16 CSP backward at T=7 launches at most 70 kernels, of which at
    most 3 a MHCA are attention kernels (the recompute's forward and the two
    of the fused backward), counted by torch.profiler after a warm-up
    profile; a profile without kernels fails."""
    from torch.profiler import ProfilerActivity, profile

    from unav_yolyolva_tpu_torch.ops.fused_csp import csp_backward

    gen = torch.Generator().manual_seed(52)
    args = _bf16_csp_args(gen, cuda, 3, 7, 8)
    g = torch.randn(3, 7, 128, generator=gen).to(cuda, torch.bfloat16)
    csp_backward(*args, g=g, attn_heads=8)
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            csp_backward(*args, g=g, attn_heads=8)
            torch.cuda.synchronize()
    rows = [(e.key, e.count) for e in prof.key_averages() if is_kernel(e)]
    n, attn = sum(c for _, c in rows), sum(c for key, c in rows if "attn" in key)
    assert 0 < n <= 70, rows
    assert attn <= 3 * 3, rows


@pytest.mark.parametrize("t", [7, 100, 224, 512])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_bf16_attention_forward_kernel(cuda, d, t):
    """The bf16 forward's attention alone (one launch) against its plain
    version as the bf16 kernels are held (norm-wise <= BF16_TOL, each one's
    gap to the same steps in fp32 within 1.25x of the other's, the same
    bits on repeat): head widths 16 to 128, T from one ragged key tile to
    MAX_T = 512, a ragged sequence and one without a valid key (exact
    zeros)."""
    from unav_yolyolva_tpu_torch.ops.fused_mhca import MAX_T, attend, attention_forward

    gen = torch.Generator().manual_seed(53 + d + t)
    heads, bf = 2, torch.bfloat16
    c, lengths = 2 * d, [t, t // 2 + 1, 0]
    q = (torch.randn(3, t, c, generator=gen) * d ** -0.5).to(cuda, bf)
    k, v = (torch.randn(3, t, c, generator=gen).to(cuda, bf) for _ in range(2))
    mask = _mask(3, t, lengths, cuda)
    before = attention_forward.launches
    out = _bf16_vs_plain(
        f"attention T{t} d{d}", lambda: attention_forward(q, k, v, mask, heads=heads),
        lambda: attend(q, k, v, mask, heads),
        lambda: attend(q.float(), k.float(), v.float(), mask, heads))
    assert attention_forward.launches == before + 2 and t <= MAX_T
    assert (out[2] == 0).all()


def test_bf16_csp_backward_routes_a_tie_across_tiles(cuda):
    """The bf16 twin of test_csp_backward_routes_a_tie_across_tiles: three
    guide tokens of each row tie at the max (_csp_args ties tokens 3 and 5;
    token 150 copies them, two 64-token tiles of the gate's scoring and a
    128-token tile of the first design's away). The forward's gate and the
    backward's rescoring score through one function on the tensor cores, so
    the backward sees the tie the forward saw and splits the max's grad over
    the three tokens: their guide grads are equal and non-zero; the forward
    and every grad are held against their plain versions as the bf16
    kernels are; two runs give the same bits."""
    from unav_yolyolva_tpu_torch.ops.fused_csp import (csp_backward, csp_backward_reference,
                                                       csp_reference, fused_csp)

    gen = torch.Generator().manual_seed(22)   # the fp32 test's inputs, in bf16
    args = _csp_args(gen, cuda, 3, 20, 128, 64, 200, 24, 4)
    args[1][:, 150] = args[1][:, 3]
    args[0], args[1] = args[0].bfloat16(), args[1].bfloat16()
    f32 = [args[0].float(), args[1].float(), *args[2:]]
    g = torch.randn(3, 20, 128, generator=gen).to(cuda, torch.bfloat16)
    _bf16_vs_plain("csp_bf16 tie", lambda: fused_csp(*args, attn_heads=4),
                   lambda: csp_reference(*args, attn_heads=4),
                   lambda: csp_reference(*f32, attn_heads=4))
    bump = _bump(args[0], args[2], gen)
    got = _bf16_grads_vs_plain(
        "csp_bwd_bf16 tie", lambda: csp_backward(*args, g=g, attn_heads=4),
        lambda: csp_backward_reference(*args, g=g, attn_heads=4),
        lambda: csp_backward_reference(*f32, g=g.float(), attn_heads=4),
        lambda sign: csp_backward(bump(sign), *args[1:], g=g, attn_heads=4))
    dguide = got[1]
    assert (dguide[:, 3].float().abs().sum(1) > 0).all()
    assert torch.equal(dguide[:, 3], dguide[:, 5]), "the tie was broken"
    assert torch.equal(dguide[:, 3], dguide[:, 150]), "the tie was broken across tiles"


@pytest.mark.parametrize("t,heads,dtype,budget", [(7, 8, torch.bfloat16, 17),
                                                  (20, 4, torch.bfloat16, 17),
                                                  (7, 4, torch.float32, 18)])
def test_bf16_csp_forward_launch_budget(cuda, t, heads, dtype, budget):
    """One CSP forward launches at most `budget` kernels: in bf16 17, the
    weights' cast, the main conv with guide_fc, four a MHCA, the projection
    conv, the gate, the final conv; in fp32 the C entry's 17 (the main conv,
    four a MHCA, guide_fc, the projection conv, the gate, the final conv)
    and the wrapper's copy of Wproj into (mid, 3, mid). Counted by
    torch.profiler (_kernel_rows)."""
    from unav_yolyolva_tpu_torch.ops.fused_csp import fused_csp

    gen = torch.Generator().manual_seed(55)
    if dtype == torch.bfloat16:
        args = _bf16_csp_args(gen, cuda, 3, t, heads)
    else:
        args = _csp_args(gen, cuda, 3, t, 128, 64, 40, 24, heads)
    assert args[0].dtype == dtype
    rows = _kernel_rows(lambda: fused_csp(*args, attn_heads=heads))
    assert 0 < sum(c for _, c in rows) <= budget, rows


@pytest.mark.parametrize("mid,heads", [(64, 16), (96, 8)])
def test_bf16_csp_gate_head_widths_off_the_chunk(cuda, mid, heads):
    """The bf16 gate at head widths 4 and 12 (not whole 16-byte chunks: the
    scoring loads them value by value): the forward and every grad of the
    backward against their plain versions as the bf16 kernels are held."""
    from unav_yolyolva_tpu_torch.ops.fused_csp import (csp_backward, csp_backward_reference,
                                                       csp_reference, fused_csp)

    gen = torch.Generator().manual_seed(56)
    args = _bf16_csp_args(gen, cuda, 3, 20, heads, mid=mid)
    f32 = [args[0].float(), args[1].float(), *args[2:]]
    g = torch.randn(3, 20, 128, generator=gen).to(cuda, torch.bfloat16)
    _bf16_vs_plain(f"csp_bf16 hc{mid // heads}", lambda: fused_csp(*args, attn_heads=heads),
                   lambda: csp_reference(*args, attn_heads=heads),
                   lambda: csp_reference(*f32, attn_heads=heads))
    bump = _bump(args[0], args[2], gen)
    _bf16_grads_vs_plain(
        f"csp_bwd_bf16 hc{mid // heads}", lambda: csp_backward(*args, g=g, attn_heads=heads),
        lambda: csp_backward_reference(*args, g=g, attn_heads=heads),
        lambda: csp_backward_reference(*f32, g=g.float(), attn_heads=heads),
        lambda sign: csp_backward(bump(sign), *args[1:], g=g, attn_heads=heads))


# (layout, epilogue, M, N, K): ragged M (not a multiple of the 64-row tile),
# N = 8, K = 40 (one stage, the second slice partly zeros) and K = 2048;
# the 1000 x 2176 cases take the 64 x 128 tiles, the others 64 x 64
_MLP_CASES = [("nt", "raw", 100, 8, 40), ("nt", "store", 100, 72, 2048),
              ("nt", "gelu", 130, 136, 40), ("nt", "ua", 100, 72, 2048),
              ("nt", "res", 100, 72, 40), ("nt", "gelu", 1000, 2176, 72),
              ("nt", "res", 1000, 2176, 2048), ("nn", "raw", 100, 8, 2048),
              ("nn", "store", 130, 136, 40), ("nn", "du", 100, 72, 2048),
              ("nn", "du", 1000, 2176, 40), ("nn", "raw", 1000, 2176, 136),
              ("tn", "raw", 72, 136, 448), ("tn", "raw", 2048, 512, 42)]
# the weight grads' row blocks: 448 in blocks of 224 (two stages of 64 and
# one of 32 each), 42 in blocks of 7 (a partial slice each)
_MLP_KBLOCK = {448: 224, 42: 7}


@pytest.mark.parametrize("layout,epi,m,n,k", _MLP_CASES)
def test_mlp_product_against_plain_and_fp64(cuda, layout, epi, m, n, k):
    """The TBlock MLP's wgmma product alone (ops/gemm_tc.py:mlp_product) in
    its three layouts and each epilogue: the fp32 sums against a bf16-valued
    fp64 product within 2x the error of fp32 torch.matmul of the same
    values; every bf16 output, and the weight grads' sums of rounded row
    blocks, against the plain version within BF16_TOL norm-wise, apart from
    rounding flips on at most 1% of the values; the same bits on repeat."""
    from unav_yolyolva_tpu_torch.ops.gemm_tc import mlp_product, mlp_product_reference

    gen = torch.Generator().manual_seed(57)
    bf = torch.bfloat16
    x = torch.randn(*((k, m) if layout == "tn" else (m, k)), generator=gen).to(cuda, bf)
    w = (torch.randn(*((n, k) if layout == "nt" else (k, n)), generator=gen) / k ** 0.5
         ).to(cuda, bf)
    kw = {"kblock": _MLP_KBLOCK[k]} if layout == "tn" else {}
    if epi in ("store", "gelu", "ua", "res"):
        kw["bias"] = (0.1 * torch.randn(n, generator=gen)).to(cuda, bf)
    if epi in ("store", "res"):
        kw["rowmask"] = torch.rand(m, generator=gen).to(cuda) > 0.2
    if epi == "res":
        kw.update(seq=10, seqmul=(1 + 0.3 * torch.randn(m // 10, n, generator=gen)).to(cuda))
        start = torch.randn(m, n, generator=gen).to(cuda)
    if epi == "du":
        kw["u"] = torch.randn(m, n, generator=gen).to(cuda, bf)

    def run():
        if epi == "res":
            kw["out"] = start.clone()
        out = mlp_product(x, w, layout, epi, **kw)
        return list(out) if epi == "ua" else [out]

    got, again = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again)), "two runs differ"
    if layout == "tn":
        # each row block's fp32 sum rounded to bf16: a flip apart from the plain
        # version's on at most 1% of the values
        ref = mlp_product_reference(x, w, layout, epi, **kw)
        assert _rel(got[0], ref) <= BF16_TOL and (got[0] != ref).float().mean() <= 0.01
        return
    if epi == "raw":
        ref64 = x.double() @ (w.double().T if layout == "nt" else w.double())
        err_k = _rel(got[0], ref64)
        err_32 = _rel(x.float() @ (w.float().T if layout == "nt" else w.float()), ref64)
        assert err_k <= 2 * err_32, f"wgmma sums {err_k:.3e} vs fp32 matmul {err_32:.3e}"
        return
    if epi == "res":
        kw["out"] = start.clone()
    ref = mlp_product_reference(x, w, layout, epi, **kw)
    refs = list(ref) if epi == "ua" else [ref]
    for out, r in zip(got, refs):
        assert out.dtype == r.dtype and torch.isfinite(out).all()
        assert _rel(out, r) <= BF16_TOL, f"{epi}: vs plain {_rel(out, r):.3e}"
        assert (out != r).float().mean() <= 0.01   # only rounding flips


def _kernel_rows(fn):
    """(name, calls) of the CUDA kernels one call of fn launches, by
    torch.profiler after a warm-up profile (a process that has profiled
    before may get a profile back without device events: the first of up
    to four with kernels counts)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    rows = []
    for attempt in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.count) for e in prof.key_averages() if is_kernel(e)]
        if attempt and rows:   # the first profile is the warm-up
            break
    return rows


def test_bf16_tblock_launch_budgets(cuda):
    """One bf16 whole-block TBlock forward launches at most 9 kernels (the
    weights' cast, ln11 + ln12, four of the MHCA, residual + ln2, fc1, fc2),
    its bf16 MHCA alone at most 5 (the weights' cast, conv + LayerNorm,
    q/k/v, the attention, proj), the fp32 TBlock forward at most 8 (no
    cast), and one bf16 backward at most 32: the first design's 34 at this
    shape (tools/bf16_tblock_ab.py's `launches` line) less the two GELU
    passes that the products' epilogues took over; none of them a GELU
    pass. Counted by torch.profiler."""
    from unav_yolyolva_tpu_torch.ops.fused_mhca import fused_mhca
    from unav_yolyolva_tpu_torch.ops.fused_tblock import fused_tblock, tblock_backward

    gen = torch.Generator().manual_seed(58)
    a = _tblock_args(gen, cuda, 3, 40, 64, 4, [40, 20, 0])
    g = torch.randn(3, 40, 64, generator=gen).to(cuda)
    rows = _kernel_rows(lambda: fused_tblock(*a, heads=4, cdtype=torch.bfloat16))
    assert 0 < sum(c for _, c in rows) <= 9, rows
    rows = _kernel_rows(lambda: fused_tblock(*a, heads=4))
    assert 0 < sum(c for _, c in rows) <= 8, rows
    x = a[0].bfloat16()
    ws = [w.to(cuda) for w in _mhca_weights(64, gen, cuda)]
    rows = _kernel_rows(lambda: fused_mhca(x, x, a[1], *ws, heads=4))
    assert 0 < sum(c for _, c in rows) <= 5, rows
    rows = _kernel_rows(lambda: tblock_backward(*a, g=g, heads=4, cdtype=torch.bfloat16))
    assert 0 < sum(c for _, c in rows) <= 32, rows
    assert not any("gelu" in k for k, _ in rows), rows


# ---- the train step's CUDA graph (train/step.py) ------------------------------------
#
# The graph path against the eager path on the same weights, batches and
# seed, cuDNN's deterministic algorithms on (its default weight-grad
# algorithms sum in a varying order): every number bit-identical. The
# eager reference takes each step through a new train step, whose first
# step of a batch's shapes runs eagerly.


def _graph_cfg(dtype="float32"):
    from unav_yolyolva_tpu_torch.core import load_config_dict

    return load_config_dict({
        "dataset": {"num_classes": 5, "max_seq_len": 64, "max_num_events": 8},
        "model": {"raw_input_dim_V": 64, "raw_input_dim_A": 16, "input_dim_V": 64,
                  "input_dim_A": 64, "embd_dim": 64, "head_dim": 64, "use_abs_pe": True},
        "opt": {"learning_rate": 1e-3, "epochs": 2, "warmup_epochs": 1, "weight_decay": 1e-4},
        "train_cfg": {"loss_weight": 1, "droppath": 0.1},
        "test_cfg": {"pre_nms_topk": 100, "max_seg_num": 20, "min_score": 0.001,
                     "nms_sigma": 0.4, "iou_threshold": 0.7},
        "tpu": {"compute_dtype": dtype},
    })


def _train_state(cfg, cuda):
    from unav_yolyolva_tpu_torch.models import build_model
    from unav_yolyolva_tpu_torch.train import create_train_state, make_optimizer

    model = build_model(cfg, device=cuda, seed=0)
    opt, _ = make_optimizer(model, cfg["opt"], 2)
    return create_train_state(model, opt, 250.0)


@pytest.fixture
def deterministic_cudnn():
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = prev


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_graph_gives_the_eager_bits(cuda, deterministic_cudnn, dtype):
    """Four steps of one batch shape (eager, captured, replayed twice), one
    of another shape (eager), one more of the first (replayed), stochastic
    depth on: the losses of every step, the parameters, the EMA, AdamW's
    moments and steps and the loss normalizer are the eager path's bits."""
    from unav_yolyolva_tpu_torch.data.synthetic import synthetic_train_batch
    from unav_yolyolva_tpu_torch.train import make_train_step

    cfg = _graph_cfg(dtype)
    gen = torch.Generator().manual_seed(21)
    batches = [synthetic_train_batch(gen, 2, 64, 64, 16, 5, 8) for _ in range(4)]
    batches += [synthetic_train_batch(gen, 3, 64, 64, 16, 5, 8),
                synthetic_train_batch(gen, 2, 64, 64, 16, 5, 8)]
    runs = {}
    for path in ("graph", "eager"):
        state = _train_state(cfg, cuda)
        step = make_train_step(state.model, state.optimizer, cfg, device=cuda)
        losses = []
        for b in batches:
            if path == "eager":
                step = make_train_step(state.model, state.optimizer, cfg, device=cuda)
            losses.append(step(state, b, 5))
            if path == "eager":
                assert (step.eager_steps, step.captures, step.replays) == (1, 0, 0)
        torch.cuda.synchronize()
        runs[path] = (state, losses)
        if path == "graph":
            assert (step.eager_steps, step.captures, step.replays) == (2, 1, 4)
    (gs, gl), (es, el) = runs["graph"], runs["eager"]
    for i, (a, b) in enumerate(zip(gl, el)):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), f"step {i + 1}: {k} {float(a[k])} != {float(b[k])}"
    assert torch.equal(gs.loss_normalizer, es.loss_normalizer) and gs.step == es.step
    for (name, p), q in zip(gs.model.named_parameters(), es.model.parameters()):
        assert torch.equal(p, q), name
    for p, q in zip(gs.ema.parameters(), es.ema.parameters()):
        assert torch.equal(p, q)
    gopt, eopt = gs.optimizer, es.optimizer
    for name, p, q in zip(gopt.names, gopt.params, eopt.params):
        sg, se = gopt.inner.state[p], eopt.inner.state[q]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sg[k], se[k]), f"{name} {k}"
    assert gopt.count == eopt.count == len(batches)


def test_train_and_eval_steps_do_not_sync_after_warm_up(cuda):
    """From pinned batches, after a train step's warm-up and capture and an
    eval step's first batch, neither step synchronizes with the host: the
    replays (with the wait on step n - 2) and a served batch run under
    torch.cuda.set_sync_debug_mode("error")."""
    from unav_yolyolva_tpu_torch.data.synthetic import synthetic_eval_batch, synthetic_train_batch
    from unav_yolyolva_tpu_torch.eval import make_eval_step
    from unav_yolyolva_tpu_torch.train import make_train_step

    cfg = _graph_cfg()
    state = _train_state(cfg, cuda)
    step = make_train_step(state.model, state.optimizer, cfg, device=cuda)
    gen = torch.Generator().manual_seed(22)
    pin = lambda b: {k: v.pin_memory() if isinstance(v, torch.Tensor) else v
                     for k, v in b.items()}
    batches = [pin(synthetic_train_batch(gen, 2, 64, 64, 16, 5, 8)) for _ in range(5)]
    served = pin(synthetic_eval_batch(gen, 4, 64, 64, 16))
    eval_step = make_eval_step(state, cfg, cuda)
    step(state, batches[0], 5)
    step(state, batches[1], 5)
    eval_step(served)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in batches[2:]:
            step(state, b, 5)
        eval_step(served)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert (step.eager_steps, step.captures, step.replays) == (1, 1, 4)


def _dependency_cfg():
    """The benchmark's unav100_dep configuration: the published widths with the
    dependency block."""
    import json
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "portbench", "configs", "unav100_dep.json")) as f:
        return json.load(f)["config"]


def test_eval_step_with_the_dependency_block_does_not_sync(cuda):
    """A served batch of 64 at the published widths with the dependency
    block, from pinned memory, after the first batch: no host sync under
    torch.cuda.set_sync_debug_mode("error"), and its detections finite."""
    from unav_yolyolva_tpu_torch.data.synthetic import synthetic_eval_batch
    from unav_yolyolva_tpu_torch.eval import make_eval_step
    from unav_yolyolva_tpu_torch.eval.step import fetch_detections
    from unav_yolyolva_tpu_torch.models import build_model

    cfg = _dependency_cfg()
    m = cfg["model"]
    step = make_eval_step(build_model(cfg, device=cuda, seed=0), cfg, cuda)
    batch = synthetic_eval_batch(torch.Generator().manual_seed(24), 64, m["max_seq_len"],
                                 m["raw_input_dim_V"], m["raw_input_dim_A"])
    batch = {k: v.pin_memory() for k, v in batch.items()}
    step(batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step(batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    dets, done = fetch_detections(out)
    if done is not None:
        done.synchronize()
    assert bool(torch.isfinite(dets["scores"]).all()) and int(dets["valid"].sum()) > 0


def test_train_step_graph_memory_stays_flat(cuda):
    """Memory after 20 steps is at most that after 3 plus one batch: the
    replays allocate nothing that stays, and at most two steps are in
    flight."""
    from unav_yolyolva_tpu_torch.data.synthetic import synthetic_train_batch
    from unav_yolyolva_tpu_torch.train import make_train_step

    cfg = _graph_cfg("bfloat16")
    state = _train_state(cfg, cuda)
    step = make_train_step(state.model, state.optimizer, cfg, device=cuda)
    gen = torch.Generator().manual_seed(23)
    batches = [synthetic_train_batch(gen, 2, 64, 64, 16, 5, 8) for _ in range(4)]
    one_batch = sum(v.numel() * v.element_size() for v in batches[0].values())
    for i in range(20):
        step(state, batches[i % 4], 5)
        if i == 2:
            torch.cuda.synchronize()
            after3 = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() <= after3 + one_batch
    assert (step.eager_steps, step.captures, step.replays) == (1, 1, 19)
