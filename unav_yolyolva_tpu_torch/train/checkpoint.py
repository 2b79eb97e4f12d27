"""Checkpoints of a train state in the port's own format.

A checkpoint is a directory `<folder>/<name>/` holding `state.pt` (one
torch.save of the model, EMA and optimizer state dicts) and `meta.json`
(epoch, step, loss normalizer). The best checkpoint (`model_best`) drops the
optimizer state. Writes are atomic: everything goes into `<name>.tmp`
(meta.json last), which is then renamed into place; the previous complete
checkpoint survives as `<name>.old` until that rename has succeeded.
load_checkpoint also reads the JAX package's checkpoints (`params.msgpack`,
`ema.msgpack`, the optional `opt_state.msgpack` beside the same
`meta.json`) without flax: utils/msgpack.py reads the bytes, the port's key
map carries params, EMA and the optimizer's moments across
(utils/convert.py: params_from_jax, opt_state_from_jax).

Data parallel: every rank calls save_checkpoint with its mesh; rank 0
writes (the states of the ranks are the same) and every rank waits at a
barrier until it has, so that a checkpoint read next (a resume, model_best
before the final evaluation) is complete on every rank.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import torch

from ..parallel.sync import barrier
from ..utils import msgpack
from ..utils.convert import opt_state_from_jax, params_from_jax
from .state import TrainState


def save_checkpoint(state: TrainState, epoch: int, folder: str, is_best: bool = False,
                    file_name: str = "checkpoint", extra_meta: Optional[Dict] = None,
                    mesh=None) -> str:
    name = "model_best" if is_best else file_name
    ckpt_dir = os.path.join(folder, name)
    if mesh is None or mesh.is_main:
        _write(state, epoch, folder, ckpt_dir, is_best, extra_meta)
    barrier(f"save {ckpt_dir}", mesh)
    return ckpt_dir


def _write(state: TrainState, epoch: int, folder: str, ckpt_dir: str, is_best: bool,
           extra_meta: Optional[Dict]) -> None:
    os.makedirs(folder, exist_ok=True)
    tmp_dir = ckpt_dir + ".tmp"
    shutil.rmtree(tmp_dir, ignore_errors=True)
    os.makedirs(tmp_dir)
    blob = {"model": state.model.state_dict(), "ema": state.ema.state_dict()}
    if not is_best:
        blob["optimizer"] = state.optimizer.state_dict()
    torch.save(blob, os.path.join(tmp_dir, "state.pt"))
    meta = {"epoch": int(epoch), "step": int(state.step),
            "loss_normalizer": float(state.loss_normalizer), "has_opt_state": not is_best}
    meta.update(extra_meta or {})
    with open(os.path.join(tmp_dir, "meta.json"), "w") as f:
        json.dump(meta, f)

    old_dir = ckpt_dir + ".old"
    shutil.rmtree(old_dir, ignore_errors=True)
    if os.path.exists(ckpt_dir):
        os.rename(ckpt_dir, old_dir)
    try:
        os.rename(tmp_dir, ckpt_dir)
    except OSError:
        # a concurrent find_latest_checkpoint restored <name>.old between the
        # two renames; the staged directory is the newer checkpoint
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        os.rename(tmp_dir, ckpt_dir)
    shutil.rmtree(old_dir, ignore_errors=True)


def _recover_displaced(folder: str) -> None:
    """Finish an interrupted swap: a `<name>.old` without `<name>` is the
    last complete checkpoint; rename it back."""
    try:
        entries = os.listdir(folder)
    except OSError:
        return
    for d in entries:
        if d.endswith(".old"):
            ckpt_dir = os.path.join(folder, d[: -len(".old")])
            if not os.path.exists(ckpt_dir) and os.path.exists(
                    os.path.join(folder, d, "meta.json")):
                try:
                    os.rename(os.path.join(folder, d), ckpt_dir)
                except OSError:
                    pass  # a concurrent saver or recoverer won the race


def is_jax_checkpoint(ckpt_dir: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, "params.msgpack"))


def load_checkpoint(ckpt_dir: str, state: TrainState) -> Dict:
    """Restore a checkpoint, the port's or the JAX package's, into `state`
    in place; returns {state, epoch, meta}. Without optimizer state (the
    best checkpoint) the optimizer is left as it is."""
    with open(os.path.join(ckpt_dir, "meta.json")) as f:
        meta = json.load(f)
    dev = state.loss_normalizer.device
    if is_jax_checkpoint(ckpt_dir):
        params = msgpack.read_file(os.path.join(ckpt_dir, "params.msgpack"))
        state.model.load_state_dict(params_from_jax(params), strict=True)
        state.ema.load_state_dict(
            params_from_jax(msgpack.read_file(os.path.join(ckpt_dir, "ema.msgpack"))),
            strict=True)
        opt_path = os.path.join(ckpt_dir, "opt_state.msgpack")
        if meta.get("has_opt_state") and os.path.exists(opt_path):
            state.optimizer.load_jax_state(
                *opt_state_from_jax(msgpack.read_file(opt_path), params))
    else:
        blob = torch.load(os.path.join(ckpt_dir, "state.pt"), map_location=dev)
        state.model.load_state_dict(blob["model"], strict=True)
        state.ema.load_state_dict(blob["ema"], strict=True)
        if meta.get("has_opt_state") and "optimizer" in blob:
            state.optimizer.load_state_dict(blob["optimizer"])
    state.loss_normalizer = torch.tensor(meta["loss_normalizer"], dtype=torch.float32,
                                         device=dev)
    state.step = int(meta["step"])
    return {"state": state, "epoch": meta["epoch"], "meta": meta}


def find_latest_checkpoint(folder: str) -> Optional[str]:
    """The last complete checkpoint directory in sorted order; staging
    (`*.tmp`) and displaced (`*.old`) directories are never candidates."""
    if os.path.exists(os.path.join(folder, "meta.json")):
        return folder
    _recover_displaced(folder)
    cands = sorted(d for d in os.listdir(folder)
                   if not d.endswith((".tmp", ".old"))
                   and os.path.exists(os.path.join(folder, d, "meta.json")))
    return os.path.join(folder, cands[-1]) if cands else None
