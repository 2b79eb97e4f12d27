"""PyTorch port vs the JAX package: the whole-block TransformerBlock on CPU.

The plain version `tblock_reference` (what the wrapper runs for CPU tensors
and what the CUDA kernels are held against on the card) against the JAX
`tblock_reference` and the Pallas kernel `tblock_fused` in interpret mode,
on the same numpy inputs and explicit branch multipliers: forward rtol/atol
2e-5 (fp32, another summation order, and the kernel's rational erf a few
ulp from torch.erf), grads through jax.vjp against torch autograd rtol/atol
2e-4 (sums over all rows in another order). Then, inside the port, the fused
branch of TransformerBlock against its module branch, and a tiny model with
FUSED_TBLOCK "always" against "never"."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from unav_yolyolva_tpu.ops.pallas_tblock import tblock_fused as jtblock_fused
from unav_yolyolva_tpu.ops.pallas_tblock import tblock_reference as jtblock_reference
from unav_yolyolva_tpu_torch.models import blocks as tb
from unav_yolyolva_tpu_torch.ops.fused_tblock import (fused_tblock, tblock_backward,
                                                      tblock_reference)
from tests._torch_port_common import close, lengths_mask, t
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)

B, T, C, HEADS = 3, 16, 128, 4
HID = 4 * C
TOL = 2e-5
GRAD_TOL = 2e-4


def _jax_packs(rng):
    """Random block weights in the JAX kernel layout (pack_tblock_params)."""
    return [(1 + 0.1 * rng.normal(size=(3, C))).astype(np.float32),
            (0.1 * rng.normal(size=(3, C))).astype(np.float32),
            (rng.normal(size=(3, 3, C)) * 0.5).astype(np.float32),
            (1 + 0.1 * rng.normal(size=(3, C))).astype(np.float32),
            (0.1 * rng.normal(size=(3, C))).astype(np.float32),
            (rng.normal(size=(4, C, C)) / np.sqrt(C)).astype(np.float32),
            (0.1 * rng.normal(size=(4, C))).astype(np.float32),
            (rng.normal(size=(C, HID)) / np.sqrt(C)).astype(np.float32),
            (0.1 * rng.normal(size=(1, HID))).astype(np.float32),
            (rng.normal(size=(HID, C)) / np.sqrt(HID)).astype(np.float32),
            (0.1 * rng.normal(size=(1, C))).astype(np.float32)]


def _to_port(lnw3, lnb3, dw, lnw, lnb, dwt, dbs, w1, b1, w2, b2):
    """JAX kernel layout -> the port's; linear, so it maps grads too."""
    return [lnw3, lnb3, np.transpose(dw, (0, 2, 1)), lnw, lnb, np.transpose(dwt, (0, 2, 1)),
            dbs, w1.T, b1[0], w2.T, b2[0]]


def _case(seed, lengths):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, C)).astype(np.float32)
    ma = (0.7 + 0.3 * rng.normal(size=(B, 1, C))).astype(np.float32)
    mm = (1.3 + 0.3 * rng.normal(size=(B, 1, C))).astype(np.float32)
    ma[1] = 0.0                      # a dropped attn branch
    return x, lengths_mask(B, T, lengths), ma, mm, _jax_packs(rng), rng


@pytest.mark.parametrize("lengths", [[16, 16, 16], [16, 5, 0]])
def test_tblock_reference_vs_jax_and_pallas(lengths):
    x, mask, ma, mm, packs, _ = _case(0, lengths)
    jargs = [jnp.asarray(a) for a in (x, mask, ma, mm, *packs)]
    port = tblock_reference(t(x), t(mask), t(ma), t(mm), *map(t, _to_port(*packs)),
                            heads=HEADS)
    close(port, jtblock_reference(*jargs, heads=HEADS), rtol=TOL, atol=TOL)
    close(port, jtblock_fused(*jargs, heads=HEADS, interpret=True), rtol=TOL, atol=TOL)
    # the CPU wrapper is the plain version
    assert torch.equal(fused_tblock(t(x), t(mask), t(ma), t(mm), *map(t, _to_port(*packs)),
                                    heads=HEADS), port)


@pytest.mark.parametrize("lengths", [[16, 11, 3], [16, 5, 0]])
def test_tblock_backward_vs_pallas_vjp(lengths):
    x, mask, ma, mm, packs, rng = _case(1, lengths)
    g = rng.normal(size=(B, T, C)).astype(np.float32)

    def f(x_, ma_, mm_, *ws):
        return jtblock_fused(x_, jnp.asarray(mask), ma_, mm_, *ws, heads=HEADS, train=True,
                             interpret=True)

    _, vjp = jax.vjp(f, *[jnp.asarray(a) for a in (x, ma, mm, *packs)])
    ref = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    port = tblock_backward(t(x), t(mask), t(ma), t(mm), *map(t, _to_port(*packs)), g=t(g),
                           heads=HEADS)
    assert len(port) == 3 + 11
    for i in range(3):                                   # dx, d(mult_a), d(mult_m)
        close(port[i], ref[i], rtol=GRAD_TOL, atol=GRAD_TOL)
    for p, r in zip(port[3:], _to_port(*ref[3:])):
        close(p, r, rtol=GRAD_TOL, atol=GRAD_TOL)
    if lengths[-1] == 0:                                 # an all-masked row: exact zeros
        assert (port[0][-1] == 0).all()


def _port_block(pdrop, seed=3):
    torch.manual_seed(seed)
    blk = tb.TransformerBlock(C, HEADS, path_pdrop=pdrop)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / max(1.0, p.shape[-1] ** 0.5))
        if pdrop:
            blk.drop_path_attn.scale.fill_(0.7)
            blk.drop_path_mlp.scale.fill_(1.2)
    return blk


def _run(blk, mode, x, mask, gen=None):
    prev, tb.FUSED_TBLOCK = tb.FUSED_TBLOCK, mode
    try:
        return blk(x, x, mask, gen)
    finally:
        tb.FUSED_TBLOCK = prev


@pytest.mark.parametrize("train", [False, True])
def test_fused_branch_matches_module_branch(train):
    """Eval, and train with pdrop 0.5 from one generator seed (the same
    draws on both paths, some rows dropped); grads too in train."""
    blk = _port_block(0.5).train(train)
    rng = np.random.default_rng(4)
    x = t(rng.normal(size=(B, T, C)).astype(np.float32))
    mask = t(lengths_mask(B, T, [16, 9, 2]))
    outs, grads = [], []
    for mode in ("never", "always"):
        blk.zero_grad()
        gen = torch.Generator().manual_seed(11) if train else None
        xr = x.clone().requires_grad_(True)
        out, out_mask = _run(blk, mode, xr, mask, gen)
        assert torch.equal(out_mask, mask)
        out.square().sum().backward()
        outs.append(out.detach())
        grads.append([xr.grad] + [p.grad.clone() for p in blk.parameters()])
    close(outs[1], outs[0].numpy(), rtol=TOL, atol=TOL)
    if train:
        draws = torch.rand((B, 1, 1), generator=torch.Generator().manual_seed(11))
        assert (torch.floor(0.5 + draws) == 0).any(), "no row dropped: the test means nothing"
    for a, b in zip(grads[1], grads[0]):
        close(a, b.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL)


def test_multiplier_mode_draws_like_forward():
    dp = tb.AffineDropPath(C, 0.5).train()
    with torch.no_grad():
        dp.scale.fill_(0.3)
    x = torch.ones(5, 7, C)
    via_forward = dp(x, torch.Generator().manual_seed(2))
    mult = dp.multiplier(5, torch.Generator().manual_seed(2))
    assert mult.shape == (5, 1, C)
    close(via_forward[:, :1], (x[:, :1] * mult).detach().numpy(), rtol=1e-6, atol=0)
    assert torch.equal(dp.eval().multiplier(5), dp.scale.view(1, 1, -1).expand(5, 1, C))


def test_tiny_model_fused_stem_matches_module_stem():
    from unav_yolyolva_tpu_torch.core import load_config_dict
    from unav_yolyolva_tpu_torch.models import build_model

    cfg = load_config_dict({
        "dataset": {"num_classes": 5, "max_seq_len": 32},
        "model": {"raw_input_dim_V": 32, "raw_input_dim_A": 16, "input_dim_V": 32,
                  "input_dim_A": 32, "embd_dim": 32, "head_dim": 32, "use_abs_pe": True},
    })
    model = build_model(cfg, device="cpu", seed=0)
    with torch.no_grad():               # the init scale of 1e-4 would hide both branches
        for mod in model.modules():
            if isinstance(mod, tb.AffineDropPath):
                mod.scale.fill_(0.5)
    rng = np.random.default_rng(5)
    mask = t(lengths_mask(2, 32, [32, 19]))
    inputs = {"visual": t(rng.normal(size=(2, 32, 32)).astype(np.float32)) * mask[..., None],
              "audio": t(rng.normal(size=(2, 32, 16)).astype(np.float32)) * mask[..., None],
              "mask": mask}
    outs = {}
    for mode in ("never", "always"):
        prev, tb.FUSED_TBLOCK = tb.FUSED_TBLOCK, mode
        try:
            with torch.no_grad():
                outs[mode] = model(inputs, with_losses=False)
        finally:
            tb.FUSED_TBLOCK = prev
    for key in ("cls_logits", "offsets"):
        for a, b in zip(outs["always"][key], outs["never"][key]):
            close(a, b.numpy(), rtol=1e-4, atol=1e-5)
