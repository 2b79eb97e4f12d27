"""PyTorch port vs the JAX package under the bf16 compute policy
(`tpu.compute_dtype: bfloat16`), on the CPU.

The JAX programs are compiled with XLA's `xla_allow_excess_precision` off,
so that every bf16 op rounds as the program writes it (XLA:CPU otherwise
keeps some bf16 intermediates in fp32, depending on how it fuses them: the
same Pallas body then differs between interpret mode and plain jit by a
bf16 rounding per op). The Pallas kernels run in interpret mode with
FUSED_MHCA "always", as the JAX package's own tests run them.

- Per kernel (MHCA, CSP layer at T 16 and 7, whole TransformerBlock): the
  port's plain bf16 version against the JAX Pallas kernel in bf16. Same
  output dtype; norm-wise gap at most 1/4 of the JAX bf16-vs-fp32 gap on the
  same inputs, and at most 2e-2.
- The dtype map: every module output of the JAX bf16 model
  (capture_intermediates) against the port's at the same names (forward
  hooks; names through the key map), the promotion rules pinned.
- The whole model: cls_logits, offsets (all levels) and the four auxiliary
  losses by the 1/4 criterion, or, where the port's fp32 sums, taken in
  another order than XLA's, round one bf16 value the other way: the logits
  pass through ~50 bf16 roundings, and one value moved by one bf16 ulp
  spreads through every later layer (moving ONE input value of the JAX
  model by one bf16 ulp moves its bf16 logits by about half the
  bf16-vs-fp32 gap). There the port is held at most 2x the JAX model's own
  move under such a one-ulp change of one input (the mean of three). Always
  at most 2e-2 norm-wise; the port at bf16 differs from the port at fp32 by
  at least 1e-4 (the policy is live).
- The bf16 product's plain version: its fp32 sums of bf16 operands against
  fp64, within 2x the error of fp32 torch.matmul.
- Parameters stay fp32; training at bf16 runs on the CPU (make_train_step
  and the train CLI, the plain bf16 backwards); a compute dtype other than
  float32 or bfloat16 is refused."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import unav_yolyolva_tpu.models.blocks as jblocks
from unav_yolyolva_tpu.core.config import load_config_dict as jcfg
from unav_yolyolva_tpu.models import build_model as jbuild
from unav_yolyolva_tpu.models.fusion import MaxSigmoidCSPLayer as JCSP
from unav_yolyolva_tpu.ops.pallas_csp import csp_fused, pack_csp_params
from unav_yolyolva_tpu.ops.pallas_fusion import mhca_fused, pack_mhca_params
from unav_yolyolva_tpu.ops.pallas_tblock import tblock_fused
from unav_yolyolva_tpu_torch.core import load_config_dict
from unav_yolyolva_tpu_torch.models import build_model
from unav_yolyolva_tpu_torch.models.blocks import MaskedMHCA
from unav_yolyolva_tpu_torch.models.fusion import MaxSigmoidCSPLayer
from unav_yolyolva_tpu_torch.ops.fused_tblock import fused_tblock
from unav_yolyolva_tpu_torch.ops.gemm_tc import bf16_matmul_reference, bf16_product_reference
from unav_yolyolva_tpu_torch.utils.convert import (build_key_map, csp_entries, mhca_entries,
                                                   params_from_jax)
from tests._torch_port_common import lengths_mask, load_port, np_tree, t
from tests.test_torch_port_tblock import _jax_packs, _to_port
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)

BF = jnp.bfloat16
EXACT = {"xla_allow_excess_precision": False}
T, NCLS, B = 32, 4, 3


def _compiled(fn, *args):
    """fn(*args) compiled without XLA's excess precision."""
    return jax.jit(fn).lower(*args).compile(EXACT)(*args)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(x) -> np.ndarray:
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _gap_ok(name, port, jax_bf16, jax_f32):
    """The per-kernel criterion: the port's gap to JAX bf16 at most 1/4 of
    the JAX bf16-vs-fp32 gap, and at most 2e-2."""
    gap, ref_gap = _rel(_np(port), _np(jax_bf16)), _rel(_np(jax_bf16), _np(jax_f32))
    assert gap <= 0.25 * ref_gap and gap <= 2e-2, (
        f"{name}: port vs JAX bf16 {gap:.3e}, JAX bf16 vs fp32 {ref_gap:.3e}")


@pytest.fixture(autouse=True, scope="module")
def _fused_mhca_always():
    prev = jblocks.FUSED_MHCA
    jblocks.FUSED_MHCA = "always"
    yield
    jblocks.FUSED_MHCA = prev


def test_mhca_bf16_vs_pallas():
    b, tt, c, h = 3, 16, 32, 4
    rng = np.random.default_rng(70)
    x1 = rng.normal(size=(b, tt, c)).astype(np.float32)
    x2 = rng.normal(size=(b, tt, c)).astype(np.float32)
    mask = lengths_mask(b, tt, [16, 9, 0])
    jmod = jblocks.MaskedMHCA(c, h)
    p = np_tree(jmod.init(jax.random.PRNGKey(0), x1, x2, mask))["params"]
    for name in ("query", "key", "value", "proj"):
        p[name]["bias"] = rng.normal(size=c).astype(np.float32) * 0.1
    packs = pack_mhca_params(p)

    def run(a1, a2):
        return mhca_fused(a1, a2, jnp.asarray(mask), *packs, heads=h, interpret=True)

    xb1, xb2 = jnp.asarray(x1).astype(BF), jnp.asarray(x2).astype(BF)
    ref = _compiled(run, xb1, xb2)
    ref32 = _compiled(run, xb1.astype(jnp.float32), xb2.astype(jnp.float32))
    port = load_port(MaskedMHCA(c, h), mhca_entries("m", ()), p, "m.")
    with torch.no_grad():
        out, _ = port(t(x1).bfloat16(), t(x2).bfloat16(), t(mask))
    assert out.dtype == torch.bfloat16 and ref.dtype == BF
    _gap_ok("mhca", out, ref, ref32)
    assert (out[2] == 0).all()


@pytest.mark.parametrize("tt,heads,lengths", [(16, 8, [16, 9, 0]), (7, 4, [7, 5, 1])])
def test_csp_bf16_vs_pallas(tt, heads, lengths):
    b, cin, mid, ng, fg = 3, 64, 16, 32, 24
    rng = np.random.default_rng(71)
    x = rng.normal(size=(b, tt, cin)).astype(np.float32)
    g = rng.normal(size=(b, ng, fg)).astype(np.float32)
    mask = lengths_mask(b, tt, lengths)
    jmod = JCSP(in_channels=cin, out_channels=2 * mid, guide_in_features=fg,
                embed_channels=mid, num_heads=heads)
    p = np_tree(jmod.init(jax.random.PRNGKey(1), x, g, mask, train=False))["params"]
    p["attn_block"]["bias"] = rng.normal(size=heads).astype(np.float32)
    packs = pack_csp_params(p)

    def run(xa, ga):
        return csp_fused(xa, ga, jnp.asarray(mask), *packs, attn_heads=heads, interpret=True)

    xb, gb = jnp.asarray(x).astype(BF), jnp.asarray(g).astype(BF)
    ref = _compiled(run, xb, gb)
    ref32 = _compiled(run, xb.astype(jnp.float32), gb.astype(jnp.float32))
    port = load_port(MaxSigmoidCSPLayer(cin, 2 * mid, fg, mid, heads),
                     csp_entries("c", ()), p, "c.")
    with torch.no_grad():
        out, _ = port(t(x).bfloat16(), t(g).bfloat16(), t(mask))
    assert out.dtype == torch.bfloat16 and ref.dtype == BF
    _gap_ok(f"csp T{tt}/{heads}", out, ref, ref32)


def test_tblock_bf16_vs_pallas(monkeypatch):
    import tests.test_torch_port_tblock as tt_

    c, h = 32, 4
    monkeypatch.setattr(tt_, "C", c)
    monkeypatch.setattr(tt_, "HID", 4 * c)
    rng = np.random.default_rng(72)
    packs = _jax_packs(rng)
    x = rng.normal(size=(B, 16, c)).astype(np.float32)
    mask = lengths_mask(B, 16, [16, 9, 0])
    ma = (0.7 + 0.3 * rng.normal(size=(B, 1, c))).astype(np.float32)
    mm = (1.3 + 0.3 * rng.normal(size=(B, 1, c))).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, mask, ma, mm, *packs)]
    ref = _compiled(lambda *a: tblock_fused(*a, heads=h, cdtype=BF, interpret=True), *args)
    ref32 = _compiled(lambda *a: tblock_fused(*a, heads=h, interpret=True), *args)
    out = fused_tblock(t(x), t(mask), t(ma), t(mm), *map(t, _to_port(*packs)), heads=h,
                       cdtype=torch.bfloat16)
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    # the residual stream is fp32 and carries x: compare the block's update
    _gap_ok("tblock", out.numpy() - x, np.asarray(ref) - x, np.asarray(ref32) - x)


def _over(dtype: str):
    return {"dataset": {"num_classes": NCLS, "max_seq_len": T, "max_num_events": 4},
            "model": {"raw_input_dim_V": 24, "raw_input_dim_A": 16, "input_dim_V": 32,
                      "input_dim_A": 32, "embd_dim": 32, "head_dim": 32,
                      "use_abs_pe": True, "class_aware": True},
            "train_cfg": {"loss_weight": 1}, "tpu": {"compute_dtype": dtype}}


def _batch(rng):
    batch = {"visual": rng.normal(size=(B, T, 24)).astype(np.float32),
             "audio": rng.normal(size=(B, T, 16)).astype(np.float32),
             "mask": lengths_mask(B, T, [T, 20, 0])}
    batch["m_start_end"] = (rng.uniform(size=(B, T)) < 0.2).astype(np.float32)
    batch["m_scores"] = rng.uniform(size=(B, T)).astype(np.float32)
    batch["m_labels"] = np.eye(NCLS, dtype=np.float32)[rng.integers(0, NCLS, size=(B, T))]
    return batch


def _one_ulp_up(batch, rng):
    """The batch with one valid visual value moved to the next bf16 value
    above its bf16 rounding."""
    moved = dict(batch)
    v = batch["visual"].copy()
    i, j, k = rng.integers(0, 2), rng.integers(0, 20), rng.integers(0, v.shape[-1])
    up = torch.tensor([v[i, j, k]]).bfloat16().view(torch.int16) + (1 if v[i, j, k] >= 0 else -1)
    v[i, j, k] = up.view(torch.bfloat16).float().item()
    moved["visual"] = v
    return moved


@pytest.fixture(scope="module")
def models():
    """The JAX model at bf16 (outputs and captured intermediates, and the
    outputs with one input value moved by one bf16 ulp, three times) and at
    fp32, with one set of PRNGKey(0) weights; the port at both dtypes with
    those weights, and its module outputs at bf16 (forward hooks)."""
    rng = np.random.default_rng(73)
    batch = _batch(rng)
    jb, jf = jbuild(jcfg(_over("bfloat16"))), jbuild(jcfg(_over("float32")))
    params = np_tree(jax.jit(lambda k, d: jf.init({"params": k, "droppath": k}, d,
                                                  train=False))(jax.random.PRNGKey(0), batch))
    run_b = jax.jit(lambda p, d: jb.apply(p, d, train=False, capture_intermediates=True,
                                          mutable=["intermediates"])
                    ).lower(params, batch).compile(EXACT)
    run_f = jax.jit(lambda p, d: jf.apply(p, d, train=False)).lower(params, batch).compile(EXACT)
    ref, inter = jax.tree.map(np.asarray, run_b(params, batch))
    ref_moved = [jax.tree.map(np.asarray, run_b(params, _one_ulp_up(batch, rng))[0])
                 for _ in range(3)]
    ref32 = jax.tree.map(np.asarray, run_f(params, batch))

    ports, fired = {}, {}
    for dtype in ("bfloat16", "float32"):
        port = build_model(load_config_dict(_over(dtype)), device="cpu", seed=None)
        port.load_state_dict(params_from_jax(params), strict=True)
        hooks = []
        if dtype == "bfloat16":
            for name, mod in port.named_modules():
                hooks.append(mod.register_forward_hook(
                    lambda m, i, o, name=name: fired.setdefault(name, []).append(o)))
        with torch.no_grad():
            ports[dtype] = (port, port({k: t(v) for k, v in batch.items()}))
        for hk in hooks:
            hk.remove()
    return dict(ref=ref, ref_moved=ref_moved, ref32=ref32, inter=inter["intermediates"],
                ports=ports, fired=fired, params=params)


def _module_pairs():
    """Port module name -> flax module path, from the key map and the
    modules that hold no parameter of their own."""
    pairs = {}
    for key, path, _ in build_key_map((2, 3, 5), True):
        tmod, fmod = key.rsplit(".", 1)[0], path[:-1]
        pairs[tmod] = fmod
        if tmod.endswith(".conv") and fmod[-1] == "conv":          # MaskedConv1D
            pairs[tmod[:-len(".conv")]] = fmod[:-1]
    fm = "backbone.fusion_module"
    pairs.update({"alignment": ("alignment",), "backbone": ("backbone",),
                  "cls_head": ("cls_head",), "reg_head": ("reg_head",),
                  "contrastive_losses": ("contrastive",), fm: ("backbone", "fusion"),
                  "alignment.multiway_list.0": ("alignment", "multiway")})
    for sub in ("attn_fusion", "ffn_video", "ffn_text"):
        pairs[f"alignment.multiway_list.0.{sub}"] = ("alignment", "multiway", sub)
    for i in range(5):
        pairs[f"{fm}.top_down_layers.{i}"] = ("backbone", "fusion", f"top_down_{i}")
        pairs[f"{fm}.bottom_up_layers.{i}"] = ("backbone", "fusion", f"bottom_up_{i}")
        pairs[f"backbone.downsample_list.{i}"] = ("backbone", f"downsample_{i}")
    pairs[f"{fm}.downsample_layers.0"] = ("backbone", "fusion", "downsample_shared")
    for i in range(2):
        for mod in "VA":
            pairs[f"backbone.self_att_{mod}.{i}"] = ("backbone", f"self_att_{mod}_{i}")
    return pairs


def _float_dtypes(out) -> set:
    """The dtypes of the floating arrays in a module's outputs (any nesting)."""
    if isinstance(out, (tuple, list)):
        return set().union(*[_float_dtypes(o) for o in out]) if out else set()
    if isinstance(out, dict):
        return set().union(*[_float_dtypes(o) for o in out.values()]) if out else set()
    if isinstance(out, torch.Tensor):
        return {str(out.dtype).replace("torch.", "")} if out.is_floating_point() else set()
    a = np.asarray(out)
    return {str(a.dtype)} if a.dtype.kind == "f" or str(a.dtype) == "bfloat16" else set()


def test_dtype_map_equals_jax(models):
    pairs, inter, fired = _module_pairs(), models["inter"], models["fired"]
    compared = []
    for name, outs in fired.items():
        if name not in pairs:
            continue
        node = inter
        for part in pairs[name]:
            node = node.get(part, {})
        assert "__call__" in node, f"no JAX intermediate at {pairs[name]} for {name}"
        got, want = _float_dtypes(outs), _float_dtypes(node["__call__"])
        assert got == want, f"{name}: port {got}, JAX {want}"
        compared.append(name)
    fm = "backbone.fusion_module"
    required = (["alignment", "alignment.multiway_list.0", "backbone", fm, "cls_head",
                 "reg_head", "cls_head.cls_head", "reg_head.offset_head",
                 "contrastive_losses", f"{fm}.downsample_layers.0"]
                + [f"backbone.self_att_{m}.{i}" for m in "VA" for i in range(2)]
                + [f"backbone.downsample_list.{i}" for i in range(5)]
                + [f"{fm}.{s}_layers.{i}" for s in ("top_down", "bottom_up") for i in range(5)]
                + [f"{h}.{k}.{i}" for h in ("cls_head", "reg_head") for k in ("head", "norm")
                   for i in range(2)])
    missing = sorted(set(required) - set(compared))
    assert not missing, f"not compared: {missing}"
    assert _float_dtypes(fired["backbone.self_att_V.0"]) == {"float32"}     # residual stream
    assert _float_dtypes(fired[f"{fm}.top_down_layers.0"]) == {"bfloat16"}
    assert _float_dtypes(fired["cls_head.cls_head"]) == {"float32"}


def test_whole_model_bf16(models):
    out = models["ports"]["bfloat16"][1]
    out32 = models["ports"]["float32"][1]
    ref, moved, ref32 = models["ref"], models["ref_moved"], models["ref32"]
    for key in ("cls_logits", "offsets"):
        assert all(o.dtype == torch.float32 for o in out[key])
        port = np.concatenate([o.numpy().ravel() for o in out[key]])
        jb = np.concatenate([np.ravel(r) for r in ref[key]])
        jf = np.concatenate([np.ravel(r) for r in ref32[key]])
        p32 = np.concatenate([o.numpy().ravel() for o in out32[key]])
        moves = [_rel(np.concatenate([np.ravel(r) for r in m[key]]), jb) for m in moved]
        gap, ref_gap, sensitivity = _rel(port, jb), _rel(jb, jf), float(np.mean(moves))
        assert gap <= 2e-2 and gap <= max(0.25 * ref_gap, 2 * sensitivity), (
            f"{key}: port vs JAX bf16 {gap:.3e}; JAX bf16 vs fp32 {ref_gap:.3e}; JAX bf16 "
            f"moved by one input value one bf16 ulp up {sensitivity:.3e}")
        assert _rel(port, p32) >= 1e-4, f"{key}: the bf16 policy is not live"
    for key in ("inter_loss", "intra_loss", "score_loss_video", "score_loss_text"):
        assert out[key].dtype == torch.float32
        got, jb, jf = float(out[key]), float(ref[key]), float(ref32[key])
        assert np.isfinite(got) and abs(got - jb) <= 0.25 * abs(jb - jf) + 1e-7 * abs(jb), (
            f"{key}: port {got}, JAX bf16 {jb}, JAX fp32 {jf}")


def test_build_model_bf16_keeps_fp32_parameters(models):
    port, _ = models["ports"]["bfloat16"]
    port32, _ = models["ports"]["float32"]
    assert port.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert set(port.state_dict()) == set(port32.state_dict())
    with pytest.raises(ValueError, match="compute_dtype"):
        load_config_dict(_over("float16"))


def test_bf16_product_reference_against_fp64():
    gen = torch.Generator().manual_seed(74)
    a = torch.randn(300, 200, generator=gen).bfloat16().float()
    w = (torch.randn(96, 200, generator=gen) / 200 ** 0.5).bfloat16().float()
    ref = a.double() @ w.double().T
    sums = bf16_matmul_reference(a, w.T)
    err, err32 = _rel(sums, ref), _rel(torch.matmul(a, w.T), ref)
    assert sums.dtype == torch.float32 and err <= 2 * err32, f"{err:.3e} vs {err32:.3e}"
    y = bf16_product_reference(a, w)
    assert y.dtype == torch.bfloat16
    # the bf16 result is the fp32 sum rounded once: within half a bf16 ulp
    # of the exact product but where the fp32 sum sits on a rounding edge
    assert (y.double() - ref).abs().le(ref.abs() * 2.0 ** -8 + 1e-6).all()


def test_training_at_bf16_runs_on_the_cpu(models, tmp_path):
    """make_train_step and the train CLI run at bf16 on the CPU (the bf16
    plain backwards) and write their outputs; parameters, optimizer state
    and losses stay fp32. A compute dtype other than float32 or bfloat16 is
    refused before any output."""
    import yaml

    from unav_yolyolva_tpu_torch.data.synthetic import make_synthetic_dataset
    from unav_yolyolva_tpu_torch.train import (create_train_state, make_optimizer,
                                               make_train_step)
    from unav_yolyolva_tpu_torch.train import cli

    cfg = load_config_dict(_over("bfloat16"))
    port = build_model(cfg, device="cpu", seed=None)
    port.load_state_dict(params_from_jax(models["params"]), strict=True)
    optimizer, _ = make_optimizer(port, cfg["opt"], 4, 1.0)
    state = create_train_state(port, optimizer, 100.0)
    step = make_train_step(port, optimizer, cfg, device="cpu")
    before = [p.detach().clone() for p in port.parameters()]
    rng = np.random.default_rng(75)
    batch = _batch(rng)
    batch.update(gt_segments=np.tile([[2.0, 9.0], [12.0, 20.0]], (B, 1, 1)).astype(np.float32),
                 gt_labels=np.zeros((B, 2), np.int32), gt_valid=np.ones((B, 2), bool))
    for _ in range(2):            # the warmup's learning rate is 0 at the first step
        losses = step(state, batch)
        assert losses["final_loss"].dtype == torch.float32
        assert torch.isfinite(losses["final_loss"])
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert any(not torch.equal(a, p) for a, p in zip(before, port.parameters()))
    assert all(v.dtype == torch.float32 for st in optimizer.inner.state.values() for v in st.values()
               if isinstance(v, torch.Tensor) and v.is_floating_point())

    synth = make_synthetic_dataset(str(tmp_path / "data"), num_videos=8, num_classes=NCLS,
                                   min_len=16, max_len=T, visual_dim=24, audio_dim=16, seed=3,
                                   events_per_video=2)
    over = _over("bfloat16")
    over["dataset"].update(json_file=synth["json_file"], feat_folder=synth["feat_folder"])
    over.update(output_folder=str(tmp_path / "out"), loader={"batch_size": 2, "num_workers": 1},
                opt=dict(epochs=1, warmup_epochs=0),
                test_cfg={"pre_nms_topk": 50, "max_seg_num": 10})
    path = tmp_path / "bf16.yaml"
    path.write_text(yaml.safe_dump(over))
    out = cli.main(cli.parse_args([str(path), "--device", "cpu", "-c", "1", "--output", "run"]))
    assert {"epoch_000", "model_best"} <= set(os.listdir(out["ckpt_folder"]))
    assert np.isfinite(out["history"][-1]["train_losses"]["final_loss"])

    bad = tmp_path / "f16.yaml"
    bad.write_text("tpu: {compute_dtype: float16}\n")
    with pytest.raises(ValueError, match="compute_dtype"):
        cli.main(cli.parse_args([str(bad), "--device", "cpu"]))
