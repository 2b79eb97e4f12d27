"""The epoch loops over a Batcher or any iterable of host batches (the
reference's train_one_epoch and valid_one_epoch)."""

from __future__ import annotations

import pickle
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..eval.postprocessing import postprocess_results
from ..eval.step import fetch_detections
from ..utils.meters import AverageMeter


def train_one_epoch(state, batches: Iterable[Dict], train_step: Callable, seed: int,
                    epoch: int, *, print_freq: int = 20, schedule: Callable = None,
                    tb_writer=None, log: Callable = print):
    """Runs train_step over `batches` (a Batcher is set to `epoch` first);
    returns (state, epoch_losses).

    Losses are read on the host every `print_freq` steps and at the last
    step (each once), and the epoch's losses are the AVERAGES of those
    samples, the reference's AverageMeter semantics, not the last value.
    With a tb_writer the sampled losses and the learning rate are logged
    against the step."""
    batch_time = AverageMeter()
    trackers: Dict[str, AverageMeter] = {}
    if hasattr(batches, "set_epoch"):
        batches.set_epoch(epoch)
    num_iters = len(batches) if hasattr(batches, "__len__") else -1
    log(f"\n[Train]: Epoch {epoch:d} started")
    start = time.time()
    losses, last = None, {}
    it = tracked = -1

    def track(losses):
        vals = {k: float(v) for k, v in losses.items()}
        for k, v in vals.items():
            trackers.setdefault(k, AverageMeter()).update(v)
        return vals

    for it, batch in enumerate(batches):
        losses = train_step(state, batch, seed)
        if it != 0 and it % print_freq == 0:
            last = track(losses)
            batch_time.update((time.time() - start) / print_freq)
            start = time.time()
            tracked = it
            if tb_writer is not None:
                lr = schedule(state.step - 1) if schedule else float("nan")
                tb_writer.add_scalar("train/learning_rate", lr, state.step)
                for k, v in last.items():
                    tb_writer.add_scalar(f"train/{k}", v, state.step)
            fl = trackers["final_loss"]
            log(f"Epoch: [{epoch:03d}][{it:05d}/{num_iters:05d}]\tTime {batch_time.val:.2f} "
                f"({batch_time.avg:.2f})\tLoss {fl.val:.2f} ({fl.avg:.2f})")
    if losses is not None and tracked != it:
        last = track(losses)
    log(f"[Train]: Epoch {epoch:d} finished")
    return state, ({k: m.avg for k, m in trackers.items()} or last)


def _pad_rows(v, n: int):
    """v zero-padded on its first axis to n rows (a numpy array or a tensor)."""
    pad = n - v.shape[0]
    if pad == 0:
        return v
    if isinstance(v, torch.Tensor):
        return torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
    return np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])


def rank_rows(batch: Dict, rows: int) -> Dict:
    """The rows an eval step over several ranks serves (the JAX loop's
    _device_batch): the rank's block of a rows_local batch (the Batcher's
    block of the batch padded to pad_to) zero-padded to `rows`, pad_to /
    world_size. Padded rows have an all-False mask and are never
    harvested."""
    arrays = {k: v for k, v in batch.items() if isinstance(v, (np.ndarray, torch.Tensor))}
    b = arrays["visual"].shape[0]
    if b > rows:
        raise ValueError(f"a rank's eval block of {b} rows exceeds its {rows}")
    return dict(batch, **{k: _pad_rows(v, rows) for k, v in arrays.items()})


def valid_one_epoch(model_or_state, batcher: Iterable[Dict], eval_step: Callable, epoch: int,
                    *, evaluator=None, output_file: Optional[str] = None,
                    ext_score_file: Optional[str] = None, print_freq: int = 20,
                    tb_writer=None, log: Callable = print):
    """Detections of every batch of `batcher` through eval_step (from
    eval.make_eval_step), then the mAP of `evaluator` (ANETdetection), or
    the detections pickled to output_file. Returns (mAP, losses): with an
    eval step made with_losses, the EPOCH-AVERAGED validation losses (the
    mean over batches of each loss, read on the host once, at the end, so
    that no batch fences the pipelined dispatch), else {}.

    model_or_state is the model eval_step serves (or a TrainState holding
    it as model or ema); the step closes over its model, so this names the
    one being validated and is checked against it.

    Batch i + 1 is dispatched before batch i's detections are read, so
    their copy to the host (started right after the step, waited on by an
    event) overlaps the next batch's compute.

    Data parallel (an eval step made with a mesh of more than one rank,
    over a rows_local Batcher: make_batcher(..., mesh=)): each rank serves
    its block of every batch, padded to the Batcher's pad_to / world
    (rank_rows); the gathered detections hold every row, so every rank
    harvests the whole batch and computes the same mAP, and only rank 0
    writes output_file. At world size 1 a partial batch is served as it
    is."""
    if evaluator is None and output_file is None:
        raise ValueError("valid_one_epoch: give an evaluator or an output_file")
    served = getattr(eval_step, "model", None)
    models = (getattr(model_or_state, "model", None), getattr(model_or_state, "ema", None),
              model_or_state)
    if served is None or not any(m is served for m in models):
        raise ValueError("valid_one_epoch: eval_step does not serve model_or_state")
    results = {"video-id": [], "t-start": [], "t-end": [], "label": [], "score": []}
    batch_time = AverageMeter()
    start = time.time()

    def harvest(video_ids, host, done):
        if done is not None:
            done.synchronize()
        dets = {k: v.cpu().numpy() for k, v in host.items()}
        for vi, vid in enumerate(video_ids):
            ok = dets["valid"][vi]
            n = int(ok.sum())
            if n == 0:
                continue
            results["video-id"].extend([vid] * n)
            results["t-start"].append(dets["segments"][vi, ok, 0])
            results["t-end"].append(dets["segments"][vi, ok, 1])
            results["label"].append(dets["labels"][vi, ok])
            results["score"].append(dets["scores"][vi, ok])

    mesh = getattr(eval_step, "mesh", None)
    world = mesh.world_size if mesh is not None else 1
    if world > 1 and not (getattr(batcher, "rows_local", False)
                          and batcher.process_count == world):
        raise ValueError(f"valid_one_epoch: an eval step over {world} ranks needs a rows_local "
                         f"Batcher of {world} processes (make_batcher(..., mesh=))")
    pending = None
    loss_samples = []          # device scalars, read once at the end
    with_losses = getattr(eval_step, "with_losses", False)
    num = len(batcher) if hasattr(batcher, "__len__") else -1
    for it, batch in enumerate(batcher):
        out = eval_step(batch if world == 1 else rank_rows(batch, batcher.pad_to // world))
        if with_losses:
            out, losses = out
            loss_samples.append(losses)
        fetched = fetch_detections(out)
        if pending is not None:
            harvest(*pending)
        pending = (batch["video_id"], *fetched)
        if it != 0 and it % print_freq == 0:
            batch_time.update((time.time() - start) / print_freq)
            start = time.time()
            log(f"Test: [{it:05d}/{num:05d}]\tTime {batch_time.val:.2f} ({batch_time.avg:.2f})")
    if pending is not None:
        harvest(*pending)

    for k in ("t-start", "t-end", "label", "score"):
        results[k] = np.concatenate(results[k]) if results[k] else np.zeros((0,))

    if evaluator is not None:
        if ext_score_file:
            results = postprocess_results(results, ext_score_file)
        _, mAP = evaluator.evaluate(results, verbose=mesh is None or mesh.is_main)
    else:
        if mesh is None or mesh.is_main:
            with open(output_file, "wb") as f:
                pickle.dump(results, f)
        mAP = 0.0
    losses = {}
    if loss_samples:
        losses = {k: float(np.mean(torch.stack([d[k] for d in loss_samples]).cpu().numpy()))
                  for k in loss_samples[0]}
    if tb_writer is not None:
        tb_writer.add_scalar("validation/mAP", mAP, epoch)
    return mAP, losses
