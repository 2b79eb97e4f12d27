"""The reference's public factory entry points for data. The model is
built by models.build_model."""

from __future__ import annotations

from typing import Dict, Sequence

from .core.registry import DATASETS
from .data.dataset import UnAV100Dataset
from .data.pipeline import make_batcher

DATASETS.register("unav100")(UnAV100Dataset)


def make_dataset(name: str, is_training: bool, split: Sequence[str], **kwargs):
    return DATASETS.build(name, is_training, split, **kwargs)


def make_data_loader(dataset, is_training: bool, cfg: Dict, seed: int = 0, device=None):
    return make_batcher(dataset, cfg, is_training, seed=seed, device=device)
