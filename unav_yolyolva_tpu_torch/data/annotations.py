"""The annotation database of an UnAV-100-style JSON file: the label
dictionary is built from ALL entries (before the split filter), then the
requested subsets are kept (the reference's UnAV100Dataset._load_json_db)."""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class VideoRecord:
    id: str
    fps: float
    duration: float
    segments: Optional[np.ndarray]  # (N, 2) seconds
    labels: Optional[np.ndarray]    # (N,) int64


def load_annotation_db(json_file: str, split: Sequence[str],
                       default_fps: Optional[float] = None
                       ) -> Tuple[List[VideoRecord], Dict[str, int]]:
    with open(json_file, "r") as fid:
        json_db = json.load(fid)["database"]

    label_dict: Dict[str, int] = {}
    for value in json_db.values():
        for act in value.get("annotations", []):
            label_dict[act["label"]] = act["label_id"]

    records: List[VideoRecord] = []
    split = tuple(s.lower() for s in split)
    for key, value in json_db.items():
        if value["subset"].lower() not in split:
            continue
        if default_fps is not None:
            fps = default_fps
        elif "fps" in value:
            fps = value["fps"]
        else:
            raise ValueError(f"Unknown FPS for video {key}")
        duration = value.get("duration", 1e8)
        ants = value.get("annotations", [])
        if ants:
            segments = np.asarray([[a["segment"][0], a["segment"][1]] for a in ants],
                                  np.float32)
            labels = np.asarray([label_dict[a["label"]] for a in ants], np.int64)
        else:
            segments, labels = None, None
        records.append(VideoRecord(key, fps, duration, segments, labels))
    return records, label_dict


def find_empty_classes(label_dict: Dict[str, int], num_classes: int) -> List[int]:
    """Class ids without any annotation."""
    if len(label_dict) == num_classes:
        return []
    present = set(label_dict.values())
    return [i for i in range(num_classes) if i not in present]
