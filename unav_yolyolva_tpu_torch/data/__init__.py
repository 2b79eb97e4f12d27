"""Inputs of the port: the UnAV-100 feature files (annotations, dataset,
collate, the Batcher and its worker processes) and synthetic data (files
on disk or in-memory batches). Batcher, make_batcher and synthetic import
torch and load on first use: a data worker imports this package without
torch (data/workers.py)."""
import importlib

from .annotations import find_empty_classes, load_annotation_db
from .dataset import UnAV100Dataset, truncate_feats
from .workers import collate

__all__ = ["Batcher", "UnAV100Dataset", "collate", "find_empty_classes",
           "load_annotation_db", "make_batcher", "synthetic", "truncate_feats"]


def __getattr__(name):
    if name in ("Batcher", "make_batcher"):
        return getattr(importlib.import_module(__name__ + ".pipeline"), name)
    if name == "synthetic":
        return importlib.import_module(__name__ + ".synthetic")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
