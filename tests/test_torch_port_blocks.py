"""PyTorch port vs the JAX package: masked primitives and blocks on CPU.

Each port module gets the flax module's weights through the port's key map
and must agree at fp32 module tolerance (rtol 1e-4, atol 1e-5)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from unav_yolyolva_tpu.models import blocks as jb
from unav_yolyolva_tpu.ops import masked as jm
from unav_yolyolva_tpu_torch.models import blocks as tb
from unav_yolyolva_tpu_torch.ops import masked as tm
from unav_yolyolva_tpu_torch.utils.convert import mhca_entries, tblock_entries
from tests._torch_port_common import (close, conv_entries, lengths_mask,
                                      load_port, np_tree, t)
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)

B, T, C, H = 3, 32, 64, 4


def _inputs(seed, lengths, c=C, length=T):
    rng = np.random.default_rng(seed)
    x1 = rng.normal(size=(B, length, c)).astype(np.float32)
    x2 = rng.normal(size=(B, length, c)).astype(np.float32)
    return x1, x2, lengths_mask(B, length, lengths)


@pytest.mark.parametrize("stride,groups", [(1, 1), (2, 1), (2, C)])
def test_masked_conv1d(stride, groups):
    x, _, mask = _inputs(0, [T, 20, 3])
    jmod = jb.MaskedConv1D(C, 3, stride=stride, groups=groups)
    params = np_tree(jmod.init(jax.random.PRNGKey(1), x, mask))["params"]
    # non-zero bias, so that the output mask is what zeroes padded frames
    params["conv"]["bias"] = np.linspace(-1, 1, C).astype(np.float32)
    ref, ref_m = jmod.apply({"params": params}, x, mask)
    port = load_port(tb.MaskedConv1D(C // groups * groups, C, 3, stride=stride,
                                     groups=groups),
                     conv_entries("", ()), params)
    out, out_m = port(t(x), t(mask))
    close(out, ref)
    np.testing.assert_array_equal(out_m.numpy(), np.asarray(ref_m))


def test_channel_layer_norm():
    x, _, _ = _inputs(1, [T] * B)
    rng = np.random.default_rng(2)
    w, b = rng.normal(size=C).astype(np.float32), rng.normal(size=C).astype(np.float32)
    ref = jb.ChannelLayerNorm().apply({"params": {"weight": w, "bias": b}}, x)
    port = tb.ChannelLayerNorm(C)
    port.load_state_dict({"weight": t(w).view(1, -1, 1), "bias": t(b).view(1, -1, 1)})
    close(port(t(x)), ref)


@pytest.mark.parametrize("case", ["self", "cross", "all_masked_row", "stride2"])
def test_masked_mhca(case):
    lengths = {"self": [T] * B, "cross": [T, 17, 5],
               "all_masked_row": [T, 0, 9], "stride2": [T, 21, 6]}[case]
    x1, x2, mask = _inputs(3, lengths)
    if case == "self":
        x2 = x1
    s = 2 if case == "stride2" else 1
    jmod = jb.MaskedMHCA(C, H, n_qx_stride=s, n_kv_stride=s)
    params = np_tree(jmod.init(jax.random.PRNGKey(4), x1, x2, mask))["params"]
    ref, ref_m = jmod.apply({"params": params}, x1, x2, mask)
    port = load_port(tb.MaskedMHCA(C, H, s, s), mhca_entries("m", ()), params, "m.")
    with torch.no_grad():
        out, out_m = port(t(x1), t(x2), t(mask))
    close(out, ref)
    np.testing.assert_array_equal(out_m.numpy(), np.asarray(ref_m))
    if case == "all_masked_row":
        assert torch.isfinite(out).all()
        assert (out[1] == 0).all()


@pytest.mark.parametrize("strides,pdrop", [((1, 1), 0.1), ((1, 1), 0.0), ((2, 2), 0.1)])
def test_transformer_block(strides, pdrop):
    x, _, mask = _inputs(5, [T, 25, 8])
    jmod = jb.TransformerBlock(C, H, n_ds_strides=strides, path_pdrop=pdrop)
    params = np_tree(jmod.init(jax.random.PRNGKey(6), x, x, mask))["params"]
    if pdrop:
        # the init scale 1e-4 would hide the branches: make them count
        for k in ("drop_path_attn", "drop_path_mlp"):
            params[k]["scale"] = np.full_like(params[k]["scale"], 0.7)
    ref, ref_m = jmod.apply({"params": params}, x, x, mask, train=False)
    port = load_port(tb.TransformerBlock(C, H, strides, path_pdrop=pdrop),
                     tblock_entries("b", (), pdrop > 0), params, "b.")
    with torch.no_grad():
        out, out_m = port(t(x), t(x), t(mask))
    close(out, ref)
    np.testing.assert_array_equal(out_m.numpy(), np.asarray(ref_m))


@pytest.mark.parametrize("seq_len", [224, 64])
def test_points(seq_len):
    from unav_yolyolva_tpu.geometry import points as jp
    from unav_yolyolva_tpu_torch.geometry import points as tp

    rr = [(0, 4), (4, 8), (8, 16), (16, 32), (32, 64), (64, 10000)]
    ref, out = jp.generate_points(seq_len, rr, 2), tp.generate_points(seq_len, rr, 2)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)
        assert o.dtype == r.dtype
    np.testing.assert_array_equal(tp.concat_points(out), jp.concat_points(ref))


def test_masked_ops():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 24, 8)).astype(np.float32)
    mask = lengths_mask(2, 24, [24, 13])
    pe = jm.sinusoid_encoding(24, 8)
    np.testing.assert_array_equal(tm.sinusoid_encoding(24, 8), pe)
    close(tm.interpolate_pe_linear(t(pe), 40), jm.interpolate_pe_linear(jnp.asarray(pe), 40))
    for n in (16, 40):
        close(tm.resample_time_linear(t(x), n), jm.resample_time_linear(jnp.asarray(x), n))
        np.testing.assert_array_equal(
            tm.resample_mask_nearest(t(mask), n).numpy(),
            np.asarray(jm.resample_mask_nearest(jnp.asarray(mask), n)))
    for n in (4, 5):
        close(tm.adaptive_avg_pool1d(t(x), n), jm.adaptive_avg_pool1d(jnp.asarray(x), n))
    np.testing.assert_array_equal(tm.masked_conv1d_out_mask(t(mask), 2).numpy(),
                                  np.asarray(jm.masked_conv1d_out_mask(jnp.asarray(mask), 2)))
