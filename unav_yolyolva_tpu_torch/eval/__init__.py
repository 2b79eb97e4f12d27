from .decode import decode_batch, postprocess_batch
from .step import make_eval_step

__all__ = ["decode_batch", "make_eval_step", "postprocess_batch"]
