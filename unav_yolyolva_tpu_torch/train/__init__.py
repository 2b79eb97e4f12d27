"""The train path: optimizer, EMA, state, step, epoch loops, checkpoints."""
from .checkpoint import find_latest_checkpoint, load_checkpoint, save_checkpoint
from .ema import ema_update
from .loop import train_one_epoch, valid_one_epoch
from .optim import ClippedAdamW, decay_mask, make_optimizer, make_schedule
from .state import TrainState, create_train_state
from .step import build_targets, make_train_step

__all__ = [
    "ClippedAdamW", "TrainState", "build_targets", "create_train_state", "decay_mask",
    "ema_update", "find_latest_checkpoint", "load_checkpoint", "make_optimizer",
    "make_schedule", "make_train_step", "save_checkpoint", "train_one_epoch",
    "valid_one_epoch",
]
