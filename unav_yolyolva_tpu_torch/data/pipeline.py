"""Fixed-shape batches of the dataset, loaded and collated by worker
processes, delivered in page-locked memory for a CUDA run.

A batch holds
  visual      (B, T, 2048) zero-padded
  audio       (B, T, 128)
  mask        (B, T) bool
  gt_segments (B, N_max, 2) feature-grid coords
  gt_labels   (B, N_max) int32
  gt_valid    (B, N_max) bool
  fps / duration / feat_stride / feat_num_frames (B,)
  video_id    list[str] (host only)
Label assignment and the per-frame targets are built on the device inside
the step (geometry/assign.py).

T follows the reference collate: training pads to max_seq_len; eval pads
every batch to max_seq_len, and a batch holding a video longer than that
rounds up to the next multiple of the largest pyramid stride
(geometry/points.py:eval_seq_len).

The arrays of a batch are views of one byte buffer (data/workers.py:
packed, unpack). Worker processes load the items and collate them into
shared-memory slots; one copier thread of the main process copies each
slot in one memcpy into a buffer from `empty`: for a CUDA run a page-locked
tensor (pinned_empty), so that the eval step can copy it to the card with
non_blocking=True while the previous batch computes, and for the CPU a
numpy array. Processes, not threads: the eval step's kernel launches keep
the main thread's interpreter lock busy for about as long as the card
computes, and loader threads starved behind them (PERF.md section 6).
The workers are forked from a server process that imported only
data/workers.py: importing torch costs seconds per process on a card's
host.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import random
import threading
import time
import weakref
from multiprocessing import shared_memory
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from .dataset import UnAV100Dataset
from .workers import SLOTS, Layout, collate, pad_to, packed, unpack, worker

__all__ = ["Batcher", "collate", "make_batcher", "pad_to", "pinned_empty"]


def pinned_empty(shape, dtype) -> torch.Tensor:
    """An uninitialised page-locked host tensor of a numpy dtype; raises if
    the memory cannot be pinned."""
    t = torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype, pin_memory=True)
    if not t.is_pinned():
        raise RuntimeError(f"pinned_empty: a {tuple(shape)} host tensor was not page-locked")
    return t


def _unpack(buf, layout: Layout) -> Dict:
    """unpack for a numpy buffer; for a torch uint8 tensor, torch views of
    its storage (so the host allocator sees every copy made from them)."""
    if not isinstance(buf, torch.Tensor):
        return unpack(buf, layout)
    return {key: buf[off: off + int(np.prod(shape)) * np.dtype(dtype).itemsize]
            .view(torch.from_numpy(np.empty(0, dtype)).dtype).view(shape)
            for (key, shape, dtype), off in zip(layout, packed(layout)[0])}


class _Pool:
    """The worker processes of one Batcher and the main process's mappings of
    their slots."""

    def __init__(self, dataset, collate_kw: Dict, num_workers: int):
        ctx = mp.get_context("forkserver")
        ctx.set_forkserver_preload([worker.__module__])
        self.active = ctx.Value("q", 0)                # the generation being served
        self.results = ctx.Queue()
        self.tasks, self.free, self.procs = [], [], []
        self.attached: Dict[Tuple[int, int], shared_memory.SharedMemory] = {}
        self.gen = 0
        for w in range(num_workers):
            self.tasks.append(ctx.Queue())
            self.free.append(ctx.Semaphore(SLOTS))
            self.procs.append(ctx.Process(
                target=worker, name=f"unav-data-worker-{w}", daemon=True,
                args=(w, dataset, collate_kw, self.tasks[w], self.results, self.free[w],
                      self.active, os.getpid())))
        for p in self.procs:
            p.start()

    def dead(self) -> List[int]:
        return [p.exitcode for p in self.procs if not p.is_alive()]

    def copy_out(self, msg, empty: Callable) -> Dict:
        """The batch of a slot message, copied in one memcpy into a buffer
        from `empty`; the slot is released."""
        _, _, w, s, name, layout, video_ids = msg
        shm = self.attached.get((w, s))
        if shm is None or shm.name != name:
            if shm is not None:
                shm.close()
            shm = self.attached[(w, s)] = shared_memory.SharedMemory(name=name)
        size = packed(layout)[1]
        dst = empty((size,), np.uint8)
        src = np.ndarray((size,), np.uint8, shm.buf)
        np.copyto(dst.numpy() if isinstance(dst, torch.Tensor) else dst, src)
        del src
        self.free[w].release()
        batch = _unpack(dst, layout)
        batch["video_id"] = video_ids
        return batch


def _close_pool(pool: _Pool) -> None:
    pool.active.value = 0
    for q in pool.tasks:
        q.put(None)
    deadline = time.monotonic() + 10.0
    for p in pool.procs:
        # drain what the workers still send, or their exit waits on the pipe
        while p.is_alive() and time.monotonic() < deadline:
            try:
                pool.results.get(timeout=0.05)
            except queue_mod.Empty:
                p.join(timeout=0.05)
        if p.is_alive():
            p.terminate()
        p.join()
    for shm in pool.attached.values():
        shm.close()
    for q in pool.tasks + [pool.results]:
        q.close()
        q.join_thread()


class Batcher:
    """Shuffling, prefetching batch iterator.

    Batch bi is made by worker bi % num_workers with that worker's own
    random.Random((seed + epoch) * 7919 + worker), so the crops and the
    order do not depend on timing (and equal the JAX package's threaded
    Batcher with as many threads). The workers start with the first
    iteration and serve every epoch until close() (or the Batcher is
    collected). At most prefetch + 2 batches from `empty` are alive at once
    (the one the consumer holds included), which bounds the pinned memory
    of a CUDA run; each worker holds two more in shared memory.
    multiprocessing re-imports the main module in each worker: a main
    module that imports torch at its top delays their start by seconds.

    `batch_size` is the GLOBAL batch. Data parallel (process_count ranks,
    the JAX Batcher's rule): every rank forms the same global batch order
    (shared seed and epoch) and loads ONLY its contiguous row block
    [pid * b / n, (pid + 1) * b / n) of each train batch (drop_last: all
    batches full; the global batch must divide over the ranks). Eval with
    `pad_to` (the padded global batch, ceil(b / n) * n) is `rows_local`:
    each rank loads the rows of its block of the padded batch, and a block
    that is all padding (a short last batch) is one zeroed template row
    (mask all False, never harvested); video_id lists every real row of
    the global batch (the eval step gathers the detections of every rank).
    """

    def __init__(self, dataset: UnAV100Dataset, batch_size: int, *, max_num_events: int = 64,
                 shuffle: bool = True, drop_last: bool = True, seed: int = 0,
                 num_workers: int = 2, prefetch: int = 4, max_div_factor: int = 1,
                 empty: Callable = np.empty, process_index: int = 0, process_count: int = 1,
                 pad_to: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.process_index, self.process_count, self.pad_to = process_index, process_count, pad_to
        if process_count > 1 and drop_last and batch_size % process_count:
            raise ValueError(f"global batch {batch_size} must divide over {process_count} "
                             f"processes")
        self.rows_local = process_count > 1 and not drop_last and pad_to > 0
        if self.rows_local and pad_to % process_count:
            raise ValueError(f"padded eval batch {pad_to} must divide over {process_count} "
                             f"processes")
        self.max_num_events = max_num_events
        self.max_div_factor = max_div_factor
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.empty = empty
        self.epoch = 0
        self._pool = None
        self._finalizer = None

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def close(self) -> None:
        """Stop the worker processes (a later iteration starts new ones)."""
        if self._finalizer is not None:
            self._finalizer()
        self._pool = self._finalizer = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _index_batches(self) -> List[List[int]]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        batches = [idx[i: i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
            if self.process_count > 1:      # this process's row block of every batch
                lb = self.batch_size // self.process_count
                batches = [b[self.process_index * lb:(self.process_index + 1) * lb]
                           for b in batches]
        return batches

    def _work(self, idxs: List[int]) -> Tuple[List[int], bool, Optional[List[str]]]:
        """(the items to load, whether the batch is a blank template row, the
        video ids it reports or None for the loaded items') of one batch."""
        if not self.rows_local:
            return idxs, False, None
        lb = self.pad_to // self.process_count
        load = idxs[self.process_index * lb:(self.process_index + 1) * lb]
        ids = [self.dataset.records[j].id for j in idxs]
        return (load, False, ids) if load else (idxs[:1], True, ids)

    def __iter__(self) -> Iterator[Dict]:
        batches = self._index_batches()
        if self._pool is None:
            collate_kw = dict(max_seq_len=self.dataset.max_seq_len,
                              max_num_events=self.max_num_events,
                              training=self.dataset.is_training,
                              max_div_factor=self.max_div_factor)
            self._pool = _Pool(self.dataset, collate_kw, self.num_workers)
            self._finalizer = weakref.finalize(self, _close_pool, self._pool)
        pool, nw = self._pool, self.num_workers
        pool.gen += 1
        gen = pool.active.value = pool.gen
        for w in range(nw):
            pool.tasks[w].put((gen, (self.seed + self.epoch) * 7919 + w,
                               [(bi, *self._work(batches[bi]))
                                for bi in range(w, len(batches), nw)]))

        ready: queue_mod.Queue = queue_mod.Queue()
        stop, finished = threading.Event(), threading.Event()
        turn = threading.Condition()
        released = [0]                      # batches the consumer is done with
        alive = self.prefetch + 2

        def copier():
            """Copies the workers' slots out in batch order, at most `alive`
            batches ahead of the consumer; after `stop` it only releases
            slots. Ends when every worker has finished this generation."""
            pending, next_bi, done = {}, 0, 0
            try:
                while done < nw:
                    try:
                        msg = pool.results.get(timeout=0.1)
                    except queue_mod.Empty:
                        if pool.dead():
                            return
                        continue
                    if msg[1] == "done":
                        done += 1
                        continue
                    if msg[1] == "error":
                        ready.put((-1, msg[3]))
                        continue
                    pending[msg[1]] = msg
                    while next_bi in pending:
                        with turn:
                            while next_bi >= released[0] + alive and not stop.is_set():
                                turn.wait(0.1)
                        msg = pending.pop(next_bi)
                        if stop.is_set():
                            pool.free[msg[2]].release()
                        else:
                            ready.put((next_bi, pool.copy_out(msg, self.empty)))
                        next_bi += 1
                for msg in pending.values():
                    pool.free[msg[2]].release()
                finished.set()
            except BaseException as e:        # re-raised by the consumer
                ready.put((-1, e))

        th = threading.Thread(target=copier, name="unav-batcher-copier", daemon=True)
        th.start()
        try:
            for bi in range(len(batches)):
                while True:
                    try:
                        got = ready.get(timeout=1.0)
                        break
                    except queue_mod.Empty:
                        if pool.dead() or not th.is_alive():
                            raise RuntimeError(f"a data worker exited (exit codes "
                                               f"{pool.dead()}; its error is on stderr)"
                                               ) from None
                if got[0] == -1:
                    raise got[1]
                yield got[1]
                with turn:
                    released[0] = bi + 1
                    turn.notify_all()
        finally:
            pool.active.value = 0           # the workers drop what is left of gen
            stop.set()
            th.join(timeout=30.0)
            if not finished.is_set():       # a worker or the copier failed: start anew
                self.close()


def make_batcher(dataset, cfg: Dict, is_training: bool, seed: int = 0,
                 device=None, mesh=None) -> Batcher:
    """The Batcher of a config. For a CUDA device (the default) batches are
    page-locked tensors; for device='cpu' numpy arrays. With a data-parallel
    `mesh` (parallel/mesh.py, on its device) the train Batcher loads only
    this rank's rows, and the eval Batcher, over more than one rank, only
    the rows of its block of the batch padded to a multiple of the world
    size (the JAX make_batcher's rule)."""
    device = mesh.device if mesh is not None else resolve_device(device)
    process_index, process_count, pad_to = 0, 1, 0
    if mesh is not None:
        process_index, process_count = mesh.rank, mesh.world_size
        if not is_training and process_count > 1:
            pad_to = -(-cfg["loader"]["batch_size"] // process_count) * process_count
    # the largest pyramid stride: the eval round-up quantum of long inputs
    mdf = cfg["model"]["scale_factor"] ** cfg["model"]["backbone_arch"][-1]
    return Batcher(
        dataset, cfg["loader"]["batch_size"],
        max_num_events=cfg["dataset"].get("max_num_events", 64),
        max_div_factor=mdf, shuffle=is_training, drop_last=is_training, seed=seed,
        num_workers=min(4, cfg["loader"].get("num_workers", 2) or 1),
        prefetch=cfg["loader"].get("prefetch", 4),
        empty=pinned_empty if device.type == "cuda" else np.empty,
        process_index=process_index, process_count=process_count, pad_to=pad_to,
    )
