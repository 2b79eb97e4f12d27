"""Weights carried across: the JAX package's flax parameter tree (and its
optimizer state's moments, opt_state_from_jax), or a reference
checkpoint's state dict -> the port's state_dict.

The port's modules are named after the reference torch key space, so its
state_dict IS a reference state dict restricted to live parameters, each
shared instance held once (`alignment.multiway_list.0.*`,
`backbone.fusion_module.downsample_layers.0.*`). This module keeps its own
copy of the key map between that space and the flax tree, with the layout
changes:
  flax Dense kernel (in, out)        -> torch Linear (out, in)
  flax Conv kernel (k, in/g, out)    -> torch Conv1d (out, in/g, k)
  Dense kernel of a 1x1 conv         -> torch Conv1d (out, in, 1)
  channel LayerNorm / AffineDropPath -> (1, C, 1)
The reference's dead parameters (never used by its forward) and the alias
indices of shared instances are neither allocated nor produced.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

# reference keys never read by its forward, and alias slots of shared
# instances: skipped when a reference checkpoint is loaded
DEAD_PREFIXES = (
    "backbone.ori_cross_att_Va.",
    "backbone.ori_cross_att_Av.",
    "backbone.cross_att_Va.",
    "backbone.cross_att_Av.",
    "backbone.fusion_module.projections.",
)
ALIAS_PREFIXES = tuple(
    [f"alignment.multiway_list.{i}." for i in range(1, 8)]
    + [f"backbone.fusion_module.downsample_layers.{i}." for i in range(1, 8)]
)


def _lin(w):        # Dense kernel -> Linear weight
    return w.T


def _conv(w):       # Conv kernel -> Conv1d weight
    return np.transpose(w, (2, 1, 0))


def _dense_1x1(w):  # Dense kernel -> Conv1d k=1 weight
    return w.T[..., None]


def _chan(w):       # (C,) or (1, 1, C) -> (1, C, 1)
    return np.reshape(w, (1, -1, 1))


def _ident(w):
    return w


def mhca_entries(t: str, f: Tuple[str, ...]):
    out = [(f"{t}.{c}.conv.weight", f + (c, "conv", "kernel"), _conv)
           for c in ("query_conv", "key_conv", "value_conv")]
    for n in ("query_norm", "key_norm", "value_norm"):
        out += [(f"{t}.{n}.weight", f + (n, "weight"), _chan),
                (f"{t}.{n}.bias", f + (n, "bias"), _chan)]
    for p in ("query", "key", "value", "proj"):
        out += [(f"{t}.{p}.weight", f + (p, "kernel"), _dense_1x1),
                (f"{t}.{p}.bias", f + (p, "bias"), _ident)]
    return out


def tblock_entries(t: str, f: Tuple[str, ...], with_droppath: bool):
    out = []
    for ln in ("ln11", "ln12", "ln2"):
        out += [(f"{t}.{ln}.weight", f + (ln, "weight"), _chan),
                (f"{t}.{ln}.bias", f + (ln, "bias"), _chan)]
    out += mhca_entries(f"{t}.attn", f + ("attn",))
    out += [(f"{t}.mlp.0.weight", f + ("mlp_fc1", "kernel"), _dense_1x1),
            (f"{t}.mlp.0.bias", f + ("mlp_fc1", "bias"), _ident),
            (f"{t}.mlp.3.weight", f + ("mlp_fc2", "kernel"), _dense_1x1),
            (f"{t}.mlp.3.bias", f + ("mlp_fc2", "bias"), _ident)]
    if with_droppath:
        out += [(f"{t}.drop_path_attn.scale", f + ("drop_path_attn", "scale"), _chan),
                (f"{t}.drop_path_mlp.scale", f + ("drop_path_mlp", "scale"), _chan)]
    return out


def _linear(t: str, f: Tuple[str, ...], fn=_lin):
    return [(f"{t}.weight", f + ("kernel",), fn), (f"{t}.bias", f + ("bias",), _ident)]


def _layernorm(t: str, f: Tuple[str, ...]):
    return [(f"{t}.weight", f + ("scale",), _ident), (f"{t}.bias", f + ("bias",), _ident)]


def csp_entries(t: str, f: Tuple[str, ...]):
    out = []
    for conv in ("main_conv", "final_conv"):
        out += [(f"{t}.{conv}.conv.weight", f + (conv, "conv", "kernel"), _conv),
                (f"{t}.{conv}.conv.bias", f + (conv, "conv", "bias"), _ident)]
    for i in range(3):
        out += mhca_entries(f"{t}.blocks.{i}", f + (f"block{i}",))
    ab, fb = f"{t}.attn_block", f + ("attn_block",)
    out += _linear(f"{ab}.guide_fc", fb + ("guide_fc",))
    out += [(f"{ab}.bias", fb + ("bias",), _ident),
            (f"{ab}.project_conv.conv.weight", fb + ("project_conv", "conv", "kernel"), _conv),
            (f"{ab}.project_conv.conv.bias", fb + ("project_conv", "conv", "bias"), _ident)]
    return out


def dependency_entries(with_droppath: bool):
    """The dependency block (models/dependency.py). The reference converter
    names none of its keys, so the port's follow the flax module names."""
    D = ("dependency",)
    e = [(f"dependency.{c}.conv.weight", D + (c, "conv", "kernel"), _conv)
         for c in ("feature_expand", "feature_squeeze")]
    for branch in ("temporal_branch", "cooccur_branch"):
        e += tblock_entries(f"dependency.{branch}", D + (branch,), with_droppath)
    return e


def build_key_map(arch=(2, 3, 5), with_droppath: bool = True,
                  with_dependency: bool = False) -> List:
    """(torch key, flax path, flax -> torch layout fn) for every live
    parameter of the model."""
    A, MW = ("alignment",), ("alignment", "multiway")
    e: List = []
    e += _linear("alignment.proj_fc_video.0", A + ("proj_fc_video",))
    e += _linear("alignment.proj_fc_text.0", A + ("proj_fc_text",))
    e += [(f"alignment.{p}", A + (p,), _ident) for p in (
        "pos_embed_video", "pos_embed_text", "type_video", "type_text",
        "cls_token_video", "cls_token_text")]
    mw = "alignment.multiway_list.0"
    e += _layernorm(f"{mw}.norm1_fused", MW + ("norm1_fused",))
    for p in ("q", "k", "v", "m"):
        e += _linear(f"{mw}.attn_fusion.{p}", MW + ("attn_fusion", p))
    e += _layernorm(f"{mw}.norm2_video", MW + ("norm2_video",))
    e += _layernorm(f"{mw}.norm2_text", MW + ("norm2_text",))
    for mod in ("video", "text"):
        for fc in ("fc1", "fc2"):
            e += _linear(f"{mw}.ffn_{mod}.{fc}", MW + (f"ffn_{mod}", fc))
    e += _layernorm("alignment.norm_video", A + ("norm_video",))
    e += _layernorm("alignment.norm_text", A + ("norm_text",))
    for mod in ("video", "text"):
        e += _linear(f"alignment.fc_{mod}.0", A + (f"fc_{mod}_lin",))
        e += _layernorm(f"alignment.fc_{mod}.3", A + (f"fc_{mod}_norm",))
        e += _linear(f"alignment.fc_{mod}_score", A + (f"fc_{mod}_score",), _dense_1x1)
        e += _linear(f"alignment.fc_{mod}_cls", A + (f"fc_{mod}_cls",))

    B = ("backbone",)
    for i in range(arch[0]):
        for mod in ("V", "A"):
            e += [(f"backbone.embd_{mod}.{i}.conv.weight",
                   B + (f"embd_{mod}_{i}", "conv", "kernel"), _conv),
                  (f"backbone.embd_norm_{mod}.{i}.weight",
                   B + (f"embd_norm_{mod}_{i}", "weight"), _chan),
                  (f"backbone.embd_norm_{mod}.{i}.bias",
                   B + (f"embd_norm_{mod}_{i}", "bias"), _chan)]
    for i in range(arch[1] - 1):
        for mod in ("V", "A"):
            e += tblock_entries(f"backbone.self_att_{mod}.{i}",
                                B + (f"self_att_{mod}_{i}",), with_droppath)
    for i in range(arch[2]):
        t, f = f"backbone.downsample_list.{i}", B + (f"downsample_{i}",)
        e += [(f"{t}.down_conv.conv.weight", f + ("down_conv", "conv", "kernel"), _conv),
              (f"{t}.down_norm.weight", f + ("down_norm", "weight"), _chan),
              (f"{t}.down_norm.bias", f + ("down_norm", "bias"), _chan)]

    F_, fm = B + ("fusion",), "backbone.fusion_module"
    e += mhca_entries(f"{fm}.text_enhancer", F_ + ("text_enhancer",))
    ds, fds = f"{fm}.downsample_layers.0", F_ + ("downsample_shared",)
    e += [(f"{ds}.down_conv.conv.weight", fds + ("down_conv", "conv", "kernel"), _conv),
          (f"{ds}.down_conv.conv.bias", fds + ("down_conv", "conv", "bias"), _ident),
          (f"{ds}.down_norm.weight", fds + ("down_norm", "weight"), _chan),
          (f"{ds}.down_norm.bias", fds + ("down_norm", "bias"), _chan)]
    for i in range(arch[2]):
        e += csp_entries(f"{fm}.top_down_layers.{i}", F_ + (f"top_down_{i}",))
        e += csp_entries(f"{fm}.bottom_up_layers.{i}", F_ + (f"bottom_up_{i}",))
    e += [(f"{fm}.match_projection.weight", F_ + ("match_projection_kernel",), _dense_1x1),
          (f"{fm}.match_projection.bias", F_ + ("match_projection_bias",), _ident)]

    for head in ("cls_head", "reg_head"):
        for i in range(2):
            e += [(f"{head}.head.{i}.conv.weight", (head, "tower", f"head_{i}", "conv", "kernel"), _conv),
                  (f"{head}.norm.{i}.weight", (head, "tower", f"norm_{i}", "weight"), _chan),
                  (f"{head}.norm.{i}.bias", (head, "tower", f"norm_{i}", "bias"), _chan)]
    e += [("cls_head.cls_head.conv.weight", ("cls_head", "cls_head", "conv", "kernel"), _conv),
          ("cls_head.cls_head.conv.bias", ("cls_head", "cls_head", "conv", "bias"), _ident),
          ("reg_head.offset_head.conv.weight", ("reg_head", "offset_head", "conv", "kernel"), _conv),
          ("reg_head.offset_head.conv.bias", ("reg_head", "offset_head", "conv", "bias"), _ident)]
    e += [(f"reg_head.scale.{lv}.scale", ("reg_head", f"scale_{lv}", "scale"), _ident)
          for lv in range(arch[2] + 1)]
    e += [("contrastive_losses.logit_scale_inter", ("contrastive", "logit_scale_inter"), _ident),
          ("contrastive_losses.NCE_video.logit_scale", ("contrastive", "nce_video_logit_scale"), _ident),
          ("contrastive_losses.NCE_text.logit_scale", ("contrastive", "nce_text_logit_scale"), _ident)]
    if with_dependency:
        e += dependency_entries(with_droppath)
    return e


def _arch_of(tree: Dict) -> Tuple[Tuple[int, int, int], bool, bool]:
    bb = tree["backbone"]
    n_embd = sum(1 for k in bb if k.startswith("embd_V_"))
    n_stem = sum(1 for k in bb if k.startswith("self_att_V_"))
    n_down = sum(1 for k in bb if k.startswith("downsample_"))
    with_dependency = "dependency" in tree
    first = (bb["self_att_V_0"] if n_stem else
             tree["dependency"]["temporal_branch"] if with_dependency else {})
    return (n_embd, n_stem + 1, n_down), "drop_path_attn" in first, with_dependency


def jax_key_map(params: Dict) -> List:
    """The key map of a JAX parameter tree (`{'params': ...}` or the inner
    tree): its architecture, droppath scales and dependency block."""
    return build_key_map(*_arch_of(params.get("params", params)))


def state_dict_from_entries(entries: List, tree: Dict) -> Dict[str, torch.Tensor]:
    """Torch tensors for `entries` of a key map, read from a flax tree."""
    sd = {}
    for key, path, fn in entries:
        node = tree
        for p in path:
            node = node[p]
        sd[key] = torch.tensor(fn(np.asarray(node, np.float32)))
    return sd


def params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """The port's state_dict from a JAX parameter tree with numpy leaves
    (`{'params': ...}` as jax.device_get gives it); loads with
    model.load_state_dict(sd, strict=True)."""
    return state_dict_from_entries(jax_key_map(params), params.get("params", params))


def unravel_like(flat: np.ndarray, params: Dict) -> Dict:
    """A flat vector in `jax.flatten_util.ravel_pytree` order of the leaves
    of `params` (dict keys sorted at every level, each leaf in C order) as a
    tree of `params`' structure."""
    pos = 0

    def walk(node):
        nonlocal pos
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        shape = np.shape(node)
        n = int(np.prod(shape))
        out = np.asarray(flat[pos: pos + n]).reshape(shape)
        pos += n
        return out

    tree = walk(params)
    if pos != np.size(flat):
        raise ValueError(f"a flat optimizer vector of {np.size(flat)} elements against "
                         f"params of {pos}")
    return tree


def _find(node, pred, path=()):
    """(path, node) of every dict under `node` for which pred holds."""
    out = []
    if isinstance(node, dict):
        if pred(node):
            out.append((path, node))
        for k, v in node.items():
            out += _find(v, pred, path + (k,))
    return out


def _outline(node, depth: int = 0) -> str:
    if not isinstance(node, dict):
        return f"array{tuple(np.shape(node))}"
    if depth == 3:
        return "{...}"
    return "{" + ", ".join(f"{k}: {_outline(v, depth + 1)}" for k, v in node.items()) + "}"


def opt_state_from_jax(opt: Dict, params: Dict):
    """(kind, count, {moment name: state dict}) of a JAX optimizer state tree
    (`opt_state.msgpack` as utils/msgpack.py restores it), its moments
    carried through the key map of `params` with the parameters' layout
    changes. Three layouts are recognised:
      * `flat_adamw` (FlatAdamWState): count, and mu / nu as single vectors
        in ravel_pytree order of the params -> 'adamw';
      * the optax chain with adamw (ScaleByAdamState: count, mu / nu trees)
        -> 'adamw';
      * the optax chain with sgd (TraceState: trace tree, the schedule's
        count beside it) -> 'sgd'.
    Moment names are torch's: exp_avg / exp_avg_sq, momentum_buffer."""
    entries = jax_key_map(params)

    def to_sd(tree):
        return state_dict_from_entries(entries, tree.get("params", tree))

    adam = _find(opt, lambda d: {"count", "mu", "nu"} <= set(d))
    trace = _find(opt, lambda d: set(d) == {"trace"})
    counts = [int(d["count"]) for _, d in _find(opt, lambda d: set(d) == {"count"})]
    if len(adam) == 1 and not trace:
        d = adam[0][1]
        if isinstance(d["mu"], dict):
            mu, nu = d["mu"], d["nu"]
        else:
            mu, nu = unravel_like(d["mu"], params), unravel_like(d["nu"], params)
        count = int(d["count"])
        if any(c != count for c in counts):
            raise ValueError(f"adam count {count} against schedule counts {counts}")
        return "adamw", count, {"exp_avg": to_sd(mu), "exp_avg_sq": to_sd(nu)}
    if len(trace) == 1 and not adam and len(set(counts)) == 1:
        return "sgd", counts[0], {"momentum_buffer": to_sd(trace[0][1]["trace"])}
    raise ValueError(f"an optimizer state of no known layout (flat_adamw, the optax adamw "
                     f"chain, the optax sgd chain): {_outline(opt)}")


def state_dict_from_reference(state_dict: Dict) -> Dict[str, torch.Tensor]:
    """A reference checkpoint's state dict (`state_dict_ema` or `state_dict`
    of a `.pth.tar`, tensors, with or without the DataParallel `module.`
    prefix) as the port's state_dict: the dead parameters and the alias
    slots of shared instances dropped, so that load_state_dict(strict=True)
    takes it."""
    out = {}
    for k, v in state_dict.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if "dependency" in k:
            raise ValueError(f"{k}: the reference names of the dependency block's keys are "
                             f"not known to the port; carry such weights across from a "
                             f"JAX checkpoint instead")
        if k.startswith(DEAD_PREFIXES) or k.startswith(ALIAS_PREFIXES):
            continue
        out[k] = torch.as_tensor(v)
    return out
