"""UnAV-100 feature dataset: .npy ingestion, seconds -> feature-grid
conversion and the training crop (the reference's
UnAV100Dataset.__getitem__ and truncate_feats). It only loads, aligns and
crops: label assignment and the per-frame targets are built on the device
inside the step (geometry/assign.py). Features stay (T, C). builders.py
registers it as "unav100"; it imports no torch (data/workers.py)."""

from __future__ import annotations

import ast
import functools
import os
import random
from typing import Dict, Optional, Sequence

import numpy as np

from .annotations import VideoRecord, find_empty_classes, load_annotation_db


@functools.lru_cache(maxsize=4096)
def _npy_header(header: bytes, encoding: str):
    """(dtype, fortran_order, shape) of a .npy header's dict."""
    d = ast.literal_eval(header.decode(encoding))
    if not isinstance(d, dict) or set(d) != {"descr", "fortran_order", "shape"}:
        raise ValueError(f"not a .npy header: {header!r}")
    dtype = np.lib.format.descr_to_dtype(d["descr"])
    if dtype.hasobject:
        raise ValueError("a .npy file of Python objects is not read")
    return dtype, bool(d["fortran_order"]), tuple(d["shape"])


def read_npy(path: str) -> np.ndarray:
    """The array of a .npy file, equal to np.load's, read with one read() and
    its header parsed once per distinct header (np.load's per-file Python
    work cost ~4x the read itself on a card's host, PERF.md section 6). The
    array is read-only: it views the bytes read."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:6] != b"\x93NUMPY" or raw[6] not in (1, 2, 3):
        raise ValueError(f"{path} is not a .npy file of format version 1-3")
    start = 10 if raw[6] == 1 else 12
    end = start + int.from_bytes(raw[8:start], "little")
    dtype, fortran, shape = _npy_header(raw[start:end], "utf8" if raw[6] == 3 else "latin1")
    arr = np.frombuffer(raw, dtype, count=int(np.prod(shape)), offset=end)
    return arr.reshape(shape, order="F" if fortran else "C")


def truncate_feats(item: Dict, max_seq_len: int, trunc_thresh: float,
                   crop_ratio: Optional[Sequence[float]] = None,
                   rng: Optional[random.Random] = None,
                   max_num_trials: int = 200) -> Dict:
    """Random training-time window crop, retried until >= 1 event keeps at
    least trunc_thresh of its span inside the window.

    item: visual (T, Cv), audio (T, Ca), segments (N, 2) grid coords, labels.
    """
    rng = rng or random
    feat_len = item["visual"].shape[0]
    segments = item["segments"]

    if feat_len <= max_seq_len:
        if crop_ratio is None:
            return item
        max_seq_len = rng.randint(max(int(round(crop_ratio[0] * feat_len)), 1),
                                  min(int(round(crop_ratio[1] * feat_len)), feat_len))
        if feat_len == max_seq_len:
            return item

    for _ in range(max_num_trials):
        st = rng.randint(0, feat_len - max_seq_len)
        ed = st + max_seq_len
        left = np.maximum(st, segments[:, 0])
        right = np.minimum(ed, segments[:, 1])
        inter = np.clip(right - left, 0, None)
        inter_ratio = inter / np.abs(segments[:, 1] - segments[:, 0])
        keep = inter_ratio >= trunc_thresh
        if keep.sum() > 0:
            break

    out = dict(item)
    out["visual"] = item["visual"][st:ed]
    out["audio"] = item["audio"][st:ed]
    out["segments"] = np.stack([left[keep], right[keep]], axis=1) - st
    out["labels"] = item["labels"][keep]
    return out


class UnAV100Dataset:
    """I3D rgb + flow visual (hstacked, 2048-d) and VGGish audio (128-d)
    features from `<prefix><video_id>_{rgb,flow,vggish}<ext>` files."""

    def __init__(self, is_training: bool, split: Sequence[str], feat_folder: str,
                 json_file: str, feat_stride: int = 8, num_frames: int = 24,
                 default_fps: Optional[float] = 25, downsample_rate: int = 1,
                 max_seq_len: int = 224, trunc_thresh: float = 0.5,
                 crop_ratio: Optional[Sequence[float]] = (0.9, 1.0),
                 num_classes: int = 100, file_prefix: Optional[str] = None,
                 file_ext: str = ".npy", **unused):
        for path in (feat_folder, json_file):
            if not os.path.exists(path):
                raise FileNotFoundError(f"UnAV100Dataset: {path} does not exist")
        self.is_training = is_training
        self.split = tuple(split)
        self.feat_folder = feat_folder
        self.file_prefix = file_prefix or ""
        self.file_ext = file_ext
        self.json_file = json_file
        self.feat_stride = feat_stride
        self.num_frames = num_frames
        self.default_fps = default_fps
        self.downsample_rate = downsample_rate
        self.max_seq_len = max_seq_len
        self.trunc_thresh = trunc_thresh
        self.crop_ratio = crop_ratio
        self.num_classes = num_classes

        self.records, self.label_dict = load_annotation_db(json_file, self.split,
                                                           default_fps)
        if len(self.label_dict) > num_classes:
            raise ValueError(f"{json_file}: {len(self.label_dict)} labels, "
                             f"num_classes {num_classes}")
        self.db_attributes = {
            "dataset_name": "unav-100",
            "tiou_thresholds": np.linspace(0.1, 0.9, 9),
            "empty_label_ids": find_empty_classes(self.label_dict, num_classes),
        }

    def get_attributes(self):
        return self.db_attributes

    def __len__(self):
        return len(self.records)

    def _feat_path(self, video_id: str, kind: str) -> str:
        return os.path.join(self.feat_folder,
                            f"{self.file_prefix}{video_id}_{kind}{self.file_ext}")

    def load_item(self, idx: int, rng: Optional[random.Random] = None) -> Dict:
        """One video's features and events; a training item is cropped with
        `rng` (the explicit stream the Batcher threads own)."""
        rec: VideoRecord = self.records[idx]
        # hstack makes the one copy of the two (read-only) file views
        rgb = read_npy(self._feat_path(rec.id, "rgb")).astype(np.float32, copy=False)
        flow = read_npy(self._feat_path(rec.id, "flow")).astype(np.float32, copy=False)
        visual = np.hstack([rgb, flow])[:: self.downsample_rate]  # (T, 2048)
        audio = read_npy(self._feat_path(rec.id, "vggish")).astype(np.float32)
        audio = audio[:: self.downsample_rate]                    # (T, 128)
        feat_stride = self.feat_stride * self.downsample_rate

        # the two modalities cut to their common length
        t = min(visual.shape[0], audio.shape[0])
        visual, audio = visual[:t], audio[:t]

        # seconds -> feature-grid coordinates
        if rec.segments is not None:
            segments = (rec.segments * rec.fps - 0.5 * self.num_frames) / feat_stride
            labels = rec.labels.copy()
        else:
            segments, labels = None, None

        item = {
            "video_id": rec.id,
            "visual": visual,
            "audio": audio,
            "segments": segments,
            "labels": labels,
            "fps": rec.fps,
            "duration": rec.duration,
            "feat_stride": feat_stride,
            "feat_num_frames": self.num_frames,
        }
        if self.is_training and segments is not None:
            item = truncate_feats(item, self.max_seq_len, self.trunc_thresh,
                                  self.crop_ratio, rng)
        return item
