"""The kernel entry point calls of one eval step of a configuration with the
dependency block (`use_dependency: True`): work.step_calls of the same
configuration with the block off, and the block's two one-head MHCA calls
at each pyramid level l (T_l = T >> l): along time over the B * classes
rows of T_l frames, and along the classes over the B * T_l rows of
`classes` entries, each at the block's width (reference/dependency.py:EMBD).
The block's other work (its two k=3 convolutions, LayerNorms and MLPs) runs
outside the kernel entry points. work.step_calls keeps refusing the block:
this module is where it is counted.
"""

from __future__ import annotations

from typing import Dict, List

from .reference.dependency import EMBD
from .work import Call
from .work import step_calls as base_step_calls


def block_calls(cfg: Dict, batch: int) -> List[Call]:
    """The block's MHCA calls in one eval step of `batch` videos."""
    m = cfg["model"]
    if cfg["tpu"]["compute_dtype"] != "float32":
        raise NotImplementedError("block_calls counts the block at float32 only")
    t, classes = m["max_seq_len"], m["num_classes"]
    calls = []
    for lv in range(m["backbone_arch"][2] + 1):
        tl = t >> lv
        calls += [Call("mhca", (batch * classes, tl, EMBD, 1), "float32", 1),
                  Call("mhca", (batch * tl, classes, EMBD, 1), "float32", 1)]
    return calls


def step_calls(cfg: Dict, batch: int, train: bool) -> List[Call]:
    """Every kernel entry point call of one eval step with the block."""
    if not cfg["model"].get("use_dependency"):
        raise ValueError("work_dependency counts configurations with the dependency block")
    if train:
        raise NotImplementedError("work_dependency counts the eval step only")
    base = dict(cfg, model=dict(cfg["model"], use_dependency=False))
    return base_step_calls(base, batch, train=False) + block_calls(cfg, batch)
