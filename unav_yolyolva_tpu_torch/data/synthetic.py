"""Synthetic UnAV-100-style data: a feature folder and annotation JSON on
disk (make_synthetic_dataset, for the dataset, the Batcher and the CLI),
and in-memory batches shaped like the collated features (I3D rgb+flow
visual, VGGish audio), made from a generator: eval batches, and train
batches with padded ground-truth events."""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

CLASS_NAMES = [f"class_{i:03d}" for i in range(200)]


def make_synthetic_dataset(root: str, *, num_videos: int = 8, num_classes: int = 10,
                           min_len: int = 48, max_len: int = 224, visual_dim: int = 2048,
                           audio_dim: int = 128, feat_stride: int = 8, num_frames: int = 24,
                           fps: float = 25.0, events_per_video: int = 3,
                           val_fraction: float = 0.5, seed: int = 0) -> Dict:
    """Write `<root>/features/<vid>_{rgb,flow,vggish}.npy` and
    `<root>/annotations.json`; returns the paths and the planted ground
    truth. Each event adds a class-coded bump to both modalities, so a
    trained model can localize it. The first val_fraction of the videos
    are the validation split, the rest train."""
    rng = np.random.default_rng(seed)
    feat_dir = os.path.join(root, "features")
    os.makedirs(feat_dir, exist_ok=True)

    sec_per_feat = feat_stride / fps
    database = {}
    for vi in range(num_videos):
        vid = f"synth_{vi:04d}"
        t = int(rng.integers(min_len, max_len + 1))
        duration = t * sec_per_feat + 0.5 * num_frames / fps

        rgb = rng.normal(0, 0.5, (t, visual_dim // 2)).astype(np.float32)
        flow = rng.normal(0, 0.5, (t, visual_dim // 2)).astype(np.float32)
        audio = rng.normal(0, 0.5, (t, audio_dim)).astype(np.float32)

        annotations = []
        for _ in range(events_per_video):
            cls = int(rng.integers(0, num_classes))
            length = int(rng.integers(4, max(5, t // 3)))
            start = int(rng.integers(0, max(1, t - length)))
            end = start + length
            rgb[start:end, cls::num_classes] += 2.0
            audio[start:end, cls::num_classes] += 2.0
            # grid -> seconds (the inverse of the dataset's conversion)
            sec0 = (start * feat_stride + 0.5 * num_frames) / fps
            sec1 = (end * feat_stride + 0.5 * num_frames) / fps
            annotations.append({"label": CLASS_NAMES[cls], "label_id": cls,
                                "segment": [round(sec0, 3), round(min(sec1, duration), 3)]})

        subset = "train" if vi >= int(num_videos * val_fraction) else "validation"
        database[vid] = {"subset": subset, "duration": round(duration, 3),
                         "annotations": annotations}
        np.save(os.path.join(feat_dir, f"{vid}_rgb.npy"), rgb)
        np.save(os.path.join(feat_dir, f"{vid}_flow.npy"), flow)
        np.save(os.path.join(feat_dir, f"{vid}_vggish.npy"), audio)

    json_file = os.path.join(root, "annotations.json")
    with open(json_file, "w") as f:
        json.dump({"database": database}, f)
    return {"feat_folder": feat_dir, "json_file": json_file, "num_classes": num_classes,
            "database": database}


def synthetic_eval_batch(gen: torch.Generator, batch: int, seq_len: int,
                         dim_v: int = 2048, dim_a: int = 128,
                         feat_stride: float = 8.0, num_frames: float = 24.0,
                         fps: float = 25.0) -> Dict[str, torch.Tensor]:
    """A batch for make_eval_step: valid lengths drawn in [16, seq_len]
    (the first video full, the last a zero-padded row with no frame, as the
    eval collate pads a final partial batch), features zero past each
    length, duration matching the length."""
    lengths = torch.randint(16, seq_len + 1, (batch,), generator=gen)
    lengths[0] = seq_len
    lengths[-1] = 0
    mask = torch.arange(seq_len)[None, :] < lengths[:, None]
    m = mask[..., None].float()
    return {
        "visual": torch.randn(batch, seq_len, dim_v, generator=gen) * m,
        "audio": torch.randn(batch, seq_len, dim_a, generator=gen) * m,
        "mask": mask,
        "fps": torch.full((batch,), fps),
        "duration": lengths.float() * feat_stride / fps,
        "feat_stride": torch.full((batch,), feat_stride),
        "feat_num_frames": torch.full((batch,), num_frames),
    }


def synthetic_train_batch(gen: torch.Generator, batch: int, seq_len: int,
                          dim_v: int = 2048, dim_a: int = 128, num_classes: int = 100,
                          max_num_events: int = 64) -> Dict[str, torch.Tensor]:
    """A batch for make_train_step: valid lengths drawn in [16, seq_len]
    (the first video full; train rows are never all padding), features zero
    past each length, and 1..4 events per video inside its valid
    frames (feature-grid units, width >= 1), padded to max_num_events with
    gt_valid False, as the train collate pads them."""
    lengths = torch.randint(16, seq_len + 1, (batch,), generator=gen)
    lengths[0] = seq_len
    mask = torch.arange(seq_len)[None, :] < lengths[:, None]
    m = mask[..., None].float()
    n_events = torch.randint(1, min(4, max_num_events) + 1, (batch,), generator=gen)
    gt_valid = torch.arange(max_num_events)[None, :] < n_events[:, None]
    span = lengths[:, None].float()
    start = torch.rand(batch, max_num_events, generator=gen) * (span - 1.0)
    width = 1.0 + torch.rand(batch, max_num_events, generator=gen) * (span / 2.0)
    segs = torch.stack([start, torch.minimum(start + width, span)], dim=-1)
    return {
        "visual": torch.randn(batch, seq_len, dim_v, generator=gen) * m,
        "audio": torch.randn(batch, seq_len, dim_a, generator=gen) * m,
        "mask": mask,
        "gt_segments": segs * gt_valid[..., None],
        "gt_labels": torch.randint(0, num_classes, (batch, max_num_events),
                                   generator=gen) * gt_valid,
        "gt_valid": gt_valid,
    }
