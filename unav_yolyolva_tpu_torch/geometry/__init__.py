from .assign import FRAME_TARGET_DIVISOR, assign_labels_batch, frame_targets_batch
from .points import concat_points, generate_points, pyramid_strides

__all__ = ["FRAME_TARGET_DIVISOR", "assign_labels_batch", "concat_points",
           "frame_targets_batch", "generate_points", "pyramid_strides"]
