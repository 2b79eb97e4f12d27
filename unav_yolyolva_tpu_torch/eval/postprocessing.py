"""External-classifier score fusion (off by default, test_cfg.ext_score_file):
the detector's segments are re-labelled with an external video-level
classifier's top-k classes, new score = sqrt(cls_score * det_score)."""

from __future__ import annotations

import json
import pickle
from typing import Dict

import numpy as np


def load_results_from_pkl(filename: str):
    with open(filename, "rb") as f:
        return pickle.load(f)


def load_results_from_json(filename: str):
    with open(filename, "r") as f:
        results = json.load(f)
    if "results" in results:
        results = results["results"]
    return results


def results_to_dict(results: Dict) -> Dict:
    """Flat arrays -> {vid: [{label, score, segment}]}."""
    out: Dict[str, list] = {vid: [] for vid in set(results["video-id"])}
    for vid, start, end, label, score in zip(results["video-id"], results["t-start"],
                                             results["t-end"], results["label"],
                                             results["score"]):
        out[vid].append({"label": int(label), "score": float(score),
                         "segment": [float(start), float(end)]})
    return out


def postprocess_results(results: Dict, cls_score_file: str, num_pred: int = 200,
                        topk: int = 2) -> Dict:
    """Each video's top num_pred detections re-emitted once for each of the
    external classifier's top-k classes of that video. A video missing from
    the score file keeps its detections unfused (the reference raises a
    KeyError there), with a warning."""
    if cls_score_file.endswith(".json"):
        cls_scores = load_results_from_json(cls_score_file)
    else:
        cls_scores = load_results_from_pkl(cls_score_file)

    vids = sorted(set(results["video-id"]))
    by_vid: Dict[str, list] = {v: [] for v in vids}
    for i, v in enumerate(results["video-id"]):
        by_vid[v].append(i)

    new = {"video-id": [], "t-start": [], "t-end": [], "label": [], "score": []}
    missing = [v for v in vids if v not in cls_scores]
    if missing:
        print(f"[postprocess] WARNING: {len(missing)} video(s) missing from "
              f"{cls_score_file}; their detections pass through unfused")
    for vid in vids:
        if vid not in cls_scores:
            for i in by_vid[vid]:
                new["video-id"].append(vid)
                for key in ("t-start", "t-end", "label", "score"):
                    new[key].append(results[key][i])
            continue
        scores = np.asarray(cls_scores[vid]).reshape(-1)
        # the reference's tie order: ascending argsort, reversed
        top_cls = np.argsort(scores)[::-1][:topk]
        det_scores = np.asarray([results["score"][i] for i in by_vid[vid]], dtype=np.float64)
        order = np.argsort(det_scores)[::-1][:num_pred]
        idxs = [by_vid[vid][j] for j in order]
        for cls in top_cls:
            cls_s = scores[cls]
            for i in idxs:
                new["video-id"].append(vid)
                new["t-start"].append(results["t-start"][i])
                new["t-end"].append(results["t-end"][i])
                new["label"].append(int(cls))
                new["score"].append(float(np.sqrt(cls_s * results["score"][i])))
    for k in ("t-start", "t-end", "label", "score"):
        new[k] = np.asarray(new[k])
    return new
