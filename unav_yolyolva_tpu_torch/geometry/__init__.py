"""Point grids (points.py) and label assignment (assign.py, torch; loaded on
first use, so that a data worker imports points.py without torch)."""
import importlib

from .points import concat_points, eval_seq_len, generate_points, pyramid_strides

__all__ = ["FRAME_TARGET_DIVISOR", "assign_labels_batch", "concat_points", "eval_seq_len",
           "frame_targets_batch", "generate_points", "pyramid_strides"]


def __getattr__(name):
    if name in ("FRAME_TARGET_DIVISOR", "assign_labels_batch", "frame_targets_batch"):
        return getattr(importlib.import_module(__name__ + ".assign"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
