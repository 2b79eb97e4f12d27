"""ActivityNet-style detection mAP (the reference's ANETdetection):
per-class AP with greedy tIoU matching (each GT locked per threshold),
VOC-2011 interpolated AP, duplicate annotations removed from the ground
truth, the observed GT labels remapped to contiguous ids. Classes are
evaluated in a plain loop, vectorized with numpy per prediction."""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np


def remove_duplicate_annotations(ants: List[Dict], tol: float = 1e-3):
    """Drop events identical in (start, end, label) within tol."""
    valid = []
    for event in ants:
        s, e, lab = event["segment"][0], event["segment"][1], event["label_id"]
        dup = any(abs(s - p["segment"][0]) <= tol and abs(e - p["segment"][1]) <= tol
                  and lab == p["label_id"] for p in valid)
        if not dup:
            valid.append(event)
    return valid


def load_gt_seg_from_json(json_file: str, split: Optional[str] = None):
    with open(json_file, "r", encoding="utf8") as f:
        db = json.load(f)["database"]
    vids, starts, stops, labels = [], [], [], []
    for k, v in db.items():
        # the split compares case-insensitively, as the dataset's does
        if split is not None and v["subset"].lower() != split.lower():
            continue
        for event in remove_duplicate_annotations(v.get("annotations", [])):
            vids.append(k)
            starts.append(float(event["segment"][0]))
            stops.append(float(event["segment"][1]))
            labels.append(int(event["label_id"]))
    return {"video-id": vids, "t-start": np.asarray(starts, np.float64),
            "t-end": np.asarray(stops, np.float64), "label": np.asarray(labels, np.int64)}


def segment_iou(target: np.ndarray, candidates: np.ndarray) -> np.ndarray:
    tt1 = np.maximum(target[0], candidates[:, 0])
    tt2 = np.minimum(target[1], candidates[:, 1])
    inter = np.clip(tt2 - tt1, 0, None)
    union = (candidates[:, 1] - candidates[:, 0]) + (target[1] - target[0]) - inter
    return inter.astype(np.float64) / union


def interpolated_prec_rec(prec: np.ndarray, rec: np.ndarray) -> float:
    """VOC-2011 interpolated AP."""
    mprec = np.hstack([[0], prec, [0]])
    mrec = np.hstack([[0], rec, [1]])
    for i in range(len(mprec) - 1)[::-1]:
        mprec[i] = max(mprec[i], mprec[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mprec[idx]))


def compute_average_precision_detection(gt: Dict[str, np.ndarray], pred: Dict[str, np.ndarray],
                                        tiou_thresholds: np.ndarray) -> np.ndarray:
    """Greedy-matching AP of one class at each tIoU threshold."""
    ap = np.zeros(len(tiou_thresholds))
    npred = len(pred["score"])
    if npred == 0:
        return ap
    npos = float(len(gt["t-start"]))

    # descending score, ties in the reference's argsort()[::-1] order
    order = pred["score"].argsort()[::-1]
    p_vid = [pred["video-id"][i] for i in order]
    p_seg = np.stack([pred["t-start"][order], pred["t-end"][order]], axis=1)

    gt_by_vid: Dict[str, List[int]] = {}
    for i, vid in enumerate(gt["video-id"]):
        gt_by_vid.setdefault(vid, []).append(i)
    gt_seg = np.stack([gt["t-start"], gt["t-end"]], axis=1)

    lock_gt = np.full((len(tiou_thresholds), int(npos)), -1, np.int64)
    tp = np.zeros((len(tiou_thresholds), npred))
    fp = np.zeros((len(tiou_thresholds), npred))

    for idx in range(npred):
        cand = gt_by_vid.get(p_vid[idx])
        if cand is None:
            fp[:, idx] = 1
            continue
        cand = np.asarray(cand)
        tiou = segment_iou(p_seg[idx], gt_seg[cand])
        sort_j = tiou.argsort()[::-1]
        for tidx, thr in enumerate(tiou_thresholds):
            matched = False
            for j in sort_j:
                if tiou[j] < thr:
                    fp[tidx, idx] = 1
                    break
                if lock_gt[tidx, cand[j]] >= 0:
                    continue
                tp[tidx, idx] = 1
                lock_gt[tidx, cand[j]] = idx
                matched = True
                break
            if not matched and fp[tidx, idx] == 0:
                fp[tidx, idx] = 1

    tp_cum = np.cumsum(tp, axis=1).astype(np.float32)
    fp_cum = np.cumsum(fp, axis=1).astype(np.float32)
    rec = tp_cum / npos
    prec = tp_cum / (tp_cum + fp_cum)
    for tidx in range(len(tiou_thresholds)):
        ap[tidx] = interpolated_prec_rec(prec[tidx], rec[tidx])
    return ap


class ANETdetection:
    """mAP evaluator over the ground truth of one split of an annotation
    file. A predicted label not among the GT labels matches no class."""

    def __init__(self, ant_file: str, split: Optional[str] = None,
                 tiou_thresholds: Sequence[float] = np.linspace(0.1, 0.5, 5),
                 dataset_name: Optional[str] = None):
        self.tiou_thresholds = np.asarray(tiou_thresholds, np.float64)
        self.dataset_name = dataset_name or ant_file
        self.ground_truth = load_gt_seg_from_json(ant_file, split=split)
        uniq = sorted(set(self.ground_truth["label"].tolist()))
        self.activity_index = {lab: i for i, lab in enumerate(uniq)}
        self.ground_truth["label"] = np.asarray(
            [self.activity_index[x] for x in self.ground_truth["label"]])

    def _split_by_label(self, table):
        out = {}
        labels = table["label"]
        for cidx in self.activity_index.values():
            sel = np.where(labels == cidx)[0]
            out[cidx] = {
                "video-id": [table["video-id"][i] for i in sel],
                "t-start": table["t-start"][sel],
                "t-end": table["t-end"][sel],
                "label": labels[sel],
                "score": table["score"][sel] if "score" in table else None,
            }
        return out

    def evaluate(self, preds: Dict, verbose: bool = True):
        """preds: video-id (list), t-start / t-end / label / score (arrays).
        Returns (mAP per tIoU, average mAP)."""
        preds = {
            "video-id": list(preds["video-id"]),
            "t-start": np.asarray(preds["t-start"], np.float64),
            "t-end": np.asarray(preds["t-end"], np.float64),
            "label": np.asarray([self.activity_index.get(int(x), -1) for x in preds["label"]]),
            "score": np.asarray(preds["score"], np.float64),
        }
        gt_by = self._split_by_label(self.ground_truth)
        pred_by = self._split_by_label(preds)
        ap = np.zeros((len(self.tiou_thresholds), len(self.activity_index)))
        for cidx in self.activity_index.values():
            ap[:, cidx] = compute_average_precision_detection(gt_by[cidx], pred_by[cidx],
                                                              self.tiou_thresholds)
        mAP = ap.mean(axis=1)
        average_mAP = mAP.mean()
        if verbose:
            print(f"[RESULTS] Action detection results on {self.dataset_name}.")
            for tiou, m in zip(self.tiou_thresholds, mAP):
                print(f"|tIoU = {tiou:.2f}: mAP = {m * 100:.2f} (%)")
            print(f"Average mAP: {average_mAP * 100:.2f} (%)")
        return mAP, average_mAP
