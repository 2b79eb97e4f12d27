"""Batches as views of one byte buffer, and the data worker processes that
collate them into shared memory.

Nothing here imports torch: a worker is forked from a server process that
has imported only this module (and numpy), because importing torch takes
seconds per process on a card's host. data/pipeline.py drives the workers.
"""

from __future__ import annotations

import os
import pickle
import queue as queue_mod
import random
import traceback
from multiprocessing import shared_memory
from typing import Callable, Dict, List, Tuple

import numpy as np

from ..geometry.points import eval_seq_len

ALIGN = 64                   # byte alignment of each array in a batch buffer
SLOTS = 2                    # shared-memory slots per worker

Layout = List[Tuple[str, Tuple[int, ...], np.dtype]]


def pad_to(arr: np.ndarray, length: int, out=None) -> np.ndarray:
    """arr cut or zero-padded to `length` rows, written into `out` when given."""
    n = min(arr.shape[0], length)
    if out is None:
        out = np.empty((length,) + arr.shape[1:], arr.dtype)
    out[:n] = arr[:n]
    out[n:] = 0
    return out


def batch_layout(items: List[Dict], *, max_seq_len: int, max_num_events: int,
                 training: bool, max_div_factor: int = 1) -> Layout:
    """(key, shape, dtype) of each array collate makes of `items`."""
    max_len = max(it["visual"].shape[0] for it in items)
    if training:
        if max_len > max_seq_len:
            raise ValueError(f"a train input of {max_len} frames exceeds max_seq_len "
                             f"{max_seq_len}")
        t = max_seq_len
    else:
        t = eval_seq_len(max_len, max_seq_len, max_div_factor)
    b, n, f32 = len(items), max_num_events, np.dtype(np.float32)
    return [("visual", (b, t) + items[0]["visual"].shape[1:], items[0]["visual"].dtype),
            ("audio", (b, t) + items[0]["audio"].shape[1:], items[0]["audio"].dtype),
            ("mask", (b, t), np.dtype(bool)),
            ("gt_segments", (b, n, 2), f32), ("gt_labels", (b, n), np.dtype(np.int32)),
            ("gt_valid", (b, n), np.dtype(bool))] + [
        (k, (b,), f32) for k in ("fps", "duration", "feat_stride", "feat_num_frames")]


def packed(layout: Layout) -> Tuple[List[int], int]:
    """The byte offset of each array of `layout` in one buffer, and its size."""
    offsets, size = [], 0
    for _, shape, dtype in layout:
        offsets.append(size)
        size += -(-int(np.prod(shape)) * np.dtype(dtype).itemsize // ALIGN) * ALIGN
    return offsets, size


def unpack(buf: np.ndarray, layout: Layout) -> Dict[str, np.ndarray]:
    """The arrays of `layout` as views of the uint8 array `buf`."""
    return {key: buf[off: off + int(np.prod(shape)) * np.dtype(dtype).itemsize]
            .view(dtype).reshape(shape)
            for (key, shape, dtype), off in zip(layout, packed(layout)[0])}


def collate(items: List[Dict], *, max_seq_len: int, max_num_events: int, training: bool,
            max_div_factor: int = 1, empty: Callable = np.empty) -> Dict:
    """One batch of `items`: its arrays are views of one uint8 array made by
    empty((size,), np.uint8) (np.empty, or a shared-memory slot) and filled
    in place."""
    layout = batch_layout(items, max_seq_len=max_seq_len, max_num_events=max_num_events,
                          training=training, max_div_factor=max_div_factor)
    out = unpack(empty((packed(layout)[1],), np.uint8), layout)
    t = out["mask"].shape[1]
    for key in ("visual", "audio"):
        for i, it in enumerate(items):
            pad_to(it[key], t, out=out[key][i])
    lens = np.asarray([it["visual"].shape[0] for it in items])
    out["mask"][:] = np.arange(t)[None, :] < lens[:, None]
    out["gt_segments"][:], out["gt_labels"][:], out["gt_valid"][:] = 0, 0, False
    for i, it in enumerate(items):
        if it["segments"] is None:
            continue
        n = min(len(it["segments"]), max_num_events)
        out["gt_segments"][i, :n] = it["segments"][:n]
        out["gt_labels"][i, :n] = it["labels"][:n]
        out["gt_valid"][i, :n] = True
    for key in ("fps", "duration", "feat_stride", "feat_num_frames"):
        out[key][:] = [it[key] for it in items]
    out["video_id"] = [it["video_id"] for it in items]
    return out


def _drop(shm) -> None:
    if shm is None:
        return
    try:
        shm.close()
    except BufferError:      # a view outlived an exception; the name still goes
        pass
    shm.unlink()


def _sendable(e: Exception, wid: int) -> Exception:
    """e with the worker's traceback as a note, or a RuntimeError carrying
    both when e does not pickle."""
    tb = "".join(traceback.format_exception(e))
    try:
        e.add_note(f"raised in data worker {wid}:\n{tb}")
        pickle.dumps(e)
        return e
    except Exception:
        return RuntimeError(f"data worker {wid}: {tb}")


def _acquire(free, active, gen: int) -> bool:
    """A free slot for generation gen, or False once gen is cancelled."""
    while active.value == gen:
        if free.acquire(timeout=0.1):
            if active.value == gen:
                return True
            free.release()
    return False


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def worker(wid: int, dataset, collate_kw: Dict, tasks, results, free, active,
           parent: int) -> None:
    """A data worker process. For each task (generation, rng seed, [(batch
    index, item indices, blank, video ids)]) it loads and collates the
    batches in order, with one random.Random(seed) across them, into its
    SLOTS shared-memory slots in turn (a slot is reused once the main
    process has copied it out and released `free`), sends each slot's name
    and layout to `results`, and ends the task with a "done" message. A
    blank batch is zeroed after its collate (one template row: mask all
    False); video ids, where given, replace the loaded items' ids. It stops
    at a None task, or when the process `parent` is gone."""
    slots = [None] * SLOTS
    turn = 0
    try:
        while True:
            try:
                task = tasks.get(timeout=1.0)
            except queue_mod.Empty:
                if not _alive(parent):
                    return
                continue
            if task is None:
                return
            gen, seed, work = task
            rng = random.Random(seed)
            for bi, idxs, blank, ids in work:
                if not _acquire(free, active, gen):
                    break
                try:
                    items = [dataset.load_item(j, rng) for j in idxs]
                    layout = batch_layout(items, **collate_kw)
                    size = packed(layout)[1]
                    if slots[turn] is None or slots[turn].size < size:
                        _drop(slots[turn])
                        slots[turn] = shared_memory.SharedMemory(create=True, size=size)
                    shm = slots[turn]
                    video_ids = collate(items, **collate_kw, empty=lambda shape, dtype:
                                        np.ndarray(shape, dtype, shm.buf))["video_id"]
                    if blank:
                        np.ndarray((size,), np.uint8, shm.buf)[:] = 0
                    if ids is not None:
                        video_ids = ids
                except Exception as e:
                    free.release()
                    results.put((gen, "error", wid, _sendable(e, wid)))
                    break
                results.put((gen, bi, wid, turn, shm.name, layout, video_ids))
                turn = (turn + 1) % SLOTS
            results.put((gen, "done", wid))
    finally:
        for shm in slots:
            _drop(shm)
