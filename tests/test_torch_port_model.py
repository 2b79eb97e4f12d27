"""PyTorch port vs the JAX package: model modules and the whole forward.

Alignment (incl. the auxiliary score losses and contrastive candidates),
FusionModule (incl. an input longer than seq_len), the backbone, the heads
at fp32 module tolerance (rtol 1e-4, atol 1e-5), and the whole
LocPointTransformer forward at the golden config for all 6 levels (logits
and offsets at rtol 2e-4, as tests/test_numerical_parity.py uses)."""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from unav_yolyolva_tpu.models import alignment as ja
from unav_yolyolva_tpu.models import backbone as jbb
from unav_yolyolva_tpu.models import fusion as jf
from unav_yolyolva_tpu.models import heads as jh
from unav_yolyolva_tpu_torch.models import alignment as ta
from unav_yolyolva_tpu_torch.models import backbone as tbb
from unav_yolyolva_tpu_torch.models import fusion as tf
from unav_yolyolva_tpu_torch.models import heads as th
from unav_yolyolva_tpu_torch.utils.convert import build_key_map, params_from_jax
from tests._torch_port_common import close, lengths_mask, load_port, np_tree, t
from tests._torch_port_common import one_torch_thread  # noqa: F401 (autouse)

B = 2


def _jit(fn, **static):
    """fn run through jax.jit (the eager flax path is several times slower)."""
    return jax.jit(functools.partial(fn, **static))


def _entries(prefix, arch=(2, 3, 2), with_droppath=True):
    return [e for e in build_key_map(arch, with_droppath) if e[0].startswith(prefix)]


def _targets(rng, b, length, ncls):
    m_start_end = (rng.uniform(size=(b, length)) < 0.2).astype(np.float32)
    m_scores = rng.uniform(size=(b, length)).astype(np.float32)
    m_labels = np.eye(ncls, dtype=np.float32)[rng.integers(0, ncls, size=(b, length))]
    return m_start_end, m_scores, m_labels


def test_alignment():
    rng = np.random.default_rng(20)
    length, ncls = 24, 5
    v = rng.normal(size=(B, length, 40)).astype(np.float32)
    a = rng.normal(size=(B, length, 12)).astype(np.float32)
    mask = lengths_mask(B, length, [length, 15])
    tg = _targets(rng, B, length, ncls)
    jmod = ja.Alignment(video_dim=40, audio_dim=12, num_hidden=32, num_classes=ncls,
                        max_positions=64)
    params = np_tree(_jit(jmod.init)(jax.random.PRNGKey(2), v, a, mask, mask, *tg))
    rv, rx, raux = _jit(jmod.apply)(params, v, a, mask, mask, *tg)
    port = load_port(ta.Alignment(40, 12, 32, num_classes=ncls, max_positions=64),
                     _entries("alignment."), {"alignment": params["params"]},
                     "alignment.")
    with torch.no_grad():
        ov, ox, oaux = port(t(v), t(a), t(mask), t(mask), tuple(t(x) for x in tg))
        ov0, ox0, none = port(t(v), t(a), t(mask), t(mask))
    close(ov, rv)
    close(ox, rx)
    assert none is None and torch.equal(ov0, ov)
    for k in ("cls_video", "cls_text", "key_video", "key_text", "nonkey_video",
              "nonkey_text", "score_loss_video", "score_loss_text"):
        close(oaux[k], raux[k])
    for k in ("key_any", "nonkey_video_valid", "nonkey_text_valid"):
        np.testing.assert_array_equal(oaux[k].numpy(), np.asarray(raux[k]))


def _pyramid(rng, length, c, levels, lengths):
    mask = lengths_mask(B, length, lengths)
    feats, masks = [], []
    for lv in range(levels):
        feats.append(rng.normal(size=(B, length >> lv, c)).astype(np.float32))
        masks.append(mask[:, :: 1 << lv])
    return feats, masks


@pytest.mark.parametrize("length", [16, 32])
def test_fusion_module(length):
    """At length 32 > seq_len 16 the guide subgraph runs on a resampled view."""
    rng = np.random.default_rng(21)
    c, seq, levels = 32, 16, 3
    feats, masks = _pyramid(rng, length, c, levels, [length, length // 2 + 1])
    txt = rng.normal(size=(B, length, c)).astype(np.float32)
    jmod = jf.FusionModule(n_embd=c, seq_len=seq, num_levels=levels)
    params = np_tree(_jit(jmod.init, train=False)(jax.random.PRNGKey(3), feats, txt,
                                                  masks, masks[0]))
    p = params["params"]
    for name in p:
        if name.startswith(("top_down", "bottom_up")):
            p[name]["attn_block"]["bias"] = rng.normal(size=p[name]["attn_block"]["bias"].shape).astype(np.float32)
    ref, ref_txt, _, ref_mtxt = _jit(jmod.apply, train=False)(
        {"params": p}, feats, txt, masks, masks[0])
    port = load_port(tf.FusionModule(c, seq, levels),
                     _entries("backbone.fusion_module.", arch=(2, 3, levels - 1)),
                     {"backbone": {"fusion": p}}, "backbone.fusion_module.")
    with torch.no_grad():
        out, out_txt, _, out_mtxt = port([t(f) for f in feats], t(txt),
                                         [t(m) for m in masks], t(masks[0]))
    for o, r in zip(out, ref):
        close(o, r)
    close(out_txt, ref_txt)
    np.testing.assert_array_equal(out_mtxt.numpy(), np.asarray(ref_mtxt))


def test_backbone():
    rng = np.random.default_rng(22)
    length, c, arch = 32, 32, (2, 3, 2)
    xv = rng.normal(size=(B, length, 24)).astype(np.float32)
    xa = rng.normal(size=(B, length, 24)).astype(np.float32)
    mask = lengths_mask(B, length, [length, 19])
    jmod = jbb.ConvTransformerBackbone(n_in_V=24, n_in_A=24, n_embd=c, max_len=length,
                                       arch=arch, path_pdrop=0.1, use_abs_pe=True)
    params = np_tree(_jit(jmod.init)(jax.random.PRNGKey(4), xv, xa, mask))
    rv, ra, rm = _jit(jmod.apply)(params, xv, xa, mask)
    port = load_port(tbb.ConvTransformerBackbone(24, 24, c, max_len=length, arch=arch,
                                                 path_pdrop=0.1, use_abs_pe=True),
                     _entries("backbone.", arch), {"backbone": params["params"]},
                     "backbone.")
    with torch.no_grad():
        ov, oa, om = port(t(xv), t(xa), t(mask))
    for o, r in zip(ov + oa, list(rv) + list(ra)):
        close(o, r)
    for o, r in zip(om, rm):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_heads():
    rng = np.random.default_rng(23)
    feats, masks = _pyramid(rng, 32, 64, 3, [32, 11])
    ncls = 5
    jcls = jh.ClsHead(feat_dim=32, num_classes=ncls, empty_cls=(1,))
    jreg = jh.RegHead(feat_dim=32, num_classes=ncls, fpn_levels=3)
    pc = np_tree(_jit(jcls.init)(jax.random.PRNGKey(5), feats, masks))["params"]
    pr = np_tree(_jit(jreg.init)(jax.random.PRNGKey(6), feats, masks))["params"]
    pr["scale_1"]["scale"] = np.asarray(0.5, np.float32)
    tree = {"cls_head": pc, "reg_head": pr}
    cls_port = load_port(th.ClsHead(64, 32, ncls, empty_cls=(1,)),
                         _entries("cls_head.", (2, 3, 2)), tree, "cls_head.")
    reg_port = load_port(th.RegHead(64, 32, ncls, 3),
                         _entries("reg_head.", (2, 3, 2)), tree, "reg_head.")
    tfeats, tmasks = [t(f) for f in feats], [t(m) for m in masks]
    with torch.no_grad():
        for o, r in zip(cls_port(tfeats, tmasks),
                        _jit(jcls.apply)({"params": pc}, feats, masks)):
            close(o, r)
        for o, r in zip(reg_port(tfeats, tmasks),
                        _jit(jreg.apply)({"params": pr}, feats, masks)):
            close(o, r)
    # the prior bias with the empty class pinned
    bias = th.cls_prior_bias(0.01, ncls, (1,)).numpy()
    np.testing.assert_allclose(bias, pc["cls_head"]["conv"]["bias"], rtol=1e-6)


@pytest.fixture(scope="module")
def golden_models():
    """The JAX model at the golden config (tests/_golden_common.py), its
    PRNGKey(0) weights, and the port with those weights loaded strictly."""
    from tests._golden_common import NCLS, T
    from unav_yolyolva_tpu.core.config import load_config_dict as jcfg
    from unav_yolyolva_tpu.models import build_model as jbuild
    from unav_yolyolva_tpu_torch.core import load_config_dict
    from unav_yolyolva_tpu_torch.models import build_model

    over = {
        "dataset": {"num_classes": NCLS, "max_seq_len": T, "max_num_events": 8},
        "model": {"raw_input_dim_V": 64, "raw_input_dim_A": 16, "input_dim_V": 32,
                  "input_dim_A": 32, "embd_dim": 32, "head_dim": 32,
                  "use_abs_pe": True, "class_aware": True},
        "train_cfg": {"loss_weight": 1},
        "test_cfg": {"pre_nms_topk": 100, "max_seg_num": 20, "min_score": 0.001,
                     "nms_sigma": 0.4, "iou_threshold": 0.7},
    }
    jmodel = jbuild(jcfg(over))
    dummy = {"visual": jnp.zeros((4, T, 64)), "audio": jnp.zeros((4, T, 16)),
             "mask": jnp.ones((4, T), bool), "m_scores": jnp.zeros((4, T)),
             "m_start_end": jnp.zeros((4, T)), "m_labels": jnp.zeros((4, T, NCLS))}
    params = np_tree(jax.jit(lambda k, d: jmodel.init(
        {"params": k, "droppath": k}, d, train=False))(jax.random.PRNGKey(0), dummy))
    cfg = load_config_dict(over)
    port = build_model(cfg, device="cpu", seed=None)
    port.load_state_dict(params_from_jax(params), strict=True)
    return jmodel, params, port, cfg


def test_state_dict_keys_are_the_reference_live_keys(golden_models):
    _, params, port, _ = golden_models
    sd = params_from_jax(params)
    assert set(sd) == set(port.state_dict())
    assert any(k.startswith("alignment.multiway_list.0.") for k in sd)
    assert not any(k.startswith("alignment.multiway_list.1.") for k in sd)
    assert not any(k.startswith("backbone.fusion_module.downsample_layers.1.") for k in sd)


def test_whole_forward(golden_models):
    from tests._golden_common import NCLS, T

    jmodel, params, port, _ = golden_models
    rng = np.random.default_rng(24)
    batch = {"visual": rng.normal(size=(B, T, 64)).astype(np.float32),
             "audio": rng.normal(size=(B, T, 16)).astype(np.float32),
             "mask": lengths_mask(B, T, [T, 41])}
    batch["m_start_end"], batch["m_scores"], batch["m_labels"] = _targets(rng, B, T, NCLS)
    ref = _jit(jmodel.apply, train=False)(params, batch)
    with torch.no_grad():
        out = port({k: t(v) for k, v in batch.items()})
    assert len(out["cls_logits"]) == 6
    for key in ("cls_logits", "offsets"):
        for o, r in zip(out[key], ref[key]):
            close(o, r, rtol=2e-4)
    for o, r in zip(out["masks"], ref["masks"]):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    for key in ("inter_loss", "intra_loss", "score_loss_video", "score_loss_text"):
        close(out[key], ref[key], rtol=2e-4)


def test_golden_eval_fixture(golden_models, tmp_path):
    """The port's make_eval_step on CPU reproduces tests/golden/eval_golden.npz
    (inputs from the JAX batcher, weights from the JAX init at PRNGKey(0)),
    at the tolerances of tests/test_golden_e2e.py, and the JAX package's
    ANETdetection gives the golden avg mAP on the port's detections."""
    import os

    from tests._golden_common import NCLS, SEED, T
    from unav_yolyolva_tpu.core.config import load_config_dict as jcfg
    from unav_yolyolva_tpu.data import UnAV100Dataset, make_batcher, synthetic
    from unav_yolyolva_tpu.eval.metrics import ANETdetection
    from unav_yolyolva_tpu_torch.eval import make_eval_step

    _, _, port, cfg = golden_models
    synth = synthetic.make_synthetic_dataset(
        str(tmp_path), num_videos=8, num_classes=NCLS, min_len=40, max_len=T,
        visual_dim=64, audio_dim=16, seed=SEED, events_per_video=2)
    data_cfg = jcfg({
        "dataset": {"json_file": synth["json_file"], "feat_folder": synth["feat_folder"],
                    "num_classes": NCLS, "max_seq_len": T, "max_num_events": 8},
        "loader": {"batch_size": 4, "num_workers": 1},
    })
    ds = UnAV100Dataset(False, ("validation",), **data_cfg["dataset"])
    eval_step = make_eval_step(port, cfg, device="cpu")
    dets, video_ids = [], []
    for batch in make_batcher(ds, data_cfg, False, seed=0):
        dets.append({k: v.numpy() for k, v in eval_step(batch).items()})
        video_ids.extend(batch["video_id"])
    dets = {k: np.concatenate([d[k] for d in dets]) for k in dets[0]}

    golden = np.load(os.path.join(os.path.dirname(__file__), "golden", "eval_golden.npz"))
    np.testing.assert_array_equal(np.asarray(video_ids), golden["video_ids"])
    np.testing.assert_array_equal(dets["valid"], golden["valid"])
    ok = golden["valid"].astype(bool)
    np.testing.assert_array_equal(dets["labels"][ok], golden["labels"][ok])
    np.testing.assert_allclose(dets["segments"][ok], golden["segments"][ok],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(dets["scores"][ok], golden["scores"][ok],
                               rtol=1e-4, atol=1e-5)

    results = {"video-id": [], "t-start": [], "t-end": [], "label": [], "score": []}
    for vi, vid in enumerate(video_ids):
        sel = dets["valid"][vi].astype(bool)
        results["video-id"].extend([vid] * int(sel.sum()))
        results["t-start"].append(dets["segments"][vi, sel, 0])
        results["t-end"].append(dets["segments"][vi, sel, 1])
        results["label"].append(dets["labels"][vi, sel])
        results["score"].append(dets["scores"][vi, sel])
    for k in ("t-start", "t-end", "label", "score"):
        results[k] = np.concatenate(results[k])
    ev = ANETdetection(synth["json_file"], "validation",
                       tiou_thresholds=np.linspace(0.1, 0.9, 9), num_workers=1)
    _, avg_map = ev.evaluate(results, verbose=False)
    np.testing.assert_allclose(avg_map, float(golden["avg_map"]), atol=1e-6)
