"""The weights of a run, made from its seed on the device in the reference
key space, in one draw: U[-1, 1) over every parameter at once, then each
leaf scaled to its kind. The same state dict loads with strict=True into
the program's model and into the reference, so neither side's initializer
makes the weights.

Scales: convolution and dense kernels U(+-1/sqrt(fan_in)) (torch's
default), the Alignment's dense kernels, tokens and embeddings at std 0.02
(its truncated normal), norms' scales 1 +- 0.1 and their offsets +- 0.1,
biases +- 0.02, the stem's branch scales in [0.05, 0.45] (a trained model's
branches carry weight, where the 1e-4 init would hide them), the head
scales 1, the contrastive logit scales log(1 / 0.07), and the class bias at
the focal prior -log(99) +- 0.1. Weights are fp32, as the program keeps
them under both compute dtypes.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

LOGIT_SCALE = math.log(1.0 / 0.07)
PRIOR = -math.log((1 - 0.01) / 0.01)


def _scale(name: str, shape) -> tuple:
    """(multiplier, offset) of U[-1, 1) for the parameter `name`."""
    leaf = name.rsplit(".", 1)[-1]
    if "logit_scale" in name:
        return 0.0, LOGIT_SCALE
    if name.startswith("reg_head.scale."):
        return 0.0, 1.0
    if ".drop_path_" in name:
        return 0.2, 0.25
    if name == "cls_head.cls_head.conv.bias":
        return 0.1, PRIOR
    if name.endswith("attn_block.bias"):
        return 0.1, 0.0
    is_norm = ("norm" in name or ".ln" in name or name.startswith("alignment.fc_video.3")
               or name.startswith("alignment.fc_text.3"))
    if is_norm:
        return (0.1, 1.0) if leaf == "weight" else (0.1, 0.0)
    if leaf == "bias":
        return 0.02, 0.0
    if name.startswith("alignment.") and (leaf != "weight" or len(shape) == 2):
        return 0.02 * math.sqrt(3.0), 0.0
    fan_in = 1
    for d in shape[1:]:
        fan_in *= d
    return 1.0 / math.sqrt(max(fan_in, 1)), 0.0


def make(shapes: Dict[str, torch.Size], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor on `device`} for the parameters `shapes`."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.rand(sum(sizes), generator=gen, device=dev).mul_(2.0).sub_(1.0)
    out = {}
    for (name, shape), part in zip(shapes.items(), torch.split(flat, sizes)):
        mul, add = _scale(name, shape)
        out[name] = part.view(shape).mul_(mul).add_(add)
    return out
