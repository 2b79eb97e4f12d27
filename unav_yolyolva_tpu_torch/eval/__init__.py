"""The serving path: decode, the eval step, the mAP evaluator, the CLI.
The step's names load on first use, so that a data worker, which
re-imports the main module (the CLI's, under `python -m`), starts without
torch."""
import importlib

__all__ = ["decode_batch", "fetch_detections", "make_eval_step", "postprocess_batch"]

_HOME = {"decode_batch": "decode", "postprocess_batch": "decode",
         "fetch_detections": "step", "make_eval_step": "step"}


def __getattr__(name):
    if name in _HOME:
        return getattr(importlib.import_module(f"{__name__}.{_HOME[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
