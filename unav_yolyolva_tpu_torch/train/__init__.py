"""The train path: optimizer, EMA, state, step, epoch loops, checkpoints, the
CLI. The names load on first use, so that a data worker, which re-imports
the main module (the CLI's, under `python -m`), starts without torch."""
import importlib

_HOME = {
    "find_latest_checkpoint": "checkpoint", "is_jax_checkpoint": "checkpoint",
    "load_checkpoint": "checkpoint", "save_checkpoint": "checkpoint",
    "ema_update": "ema", "train_one_epoch": "loop", "valid_one_epoch": "loop",
    "ClippedAdamW": "optim", "ClippedOptimizer": "optim", "ClippedSGD": "optim",
    "decay_mask": "optim", "make_optimizer": "optim", "make_schedule": "optim",
    "TrainState": "state", "create_train_state": "state",
    "build_targets": "step", "make_train_step": "step",
}
__all__ = sorted(_HOME)


def __getattr__(name):
    if name in _HOME:
        return getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
