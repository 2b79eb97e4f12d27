"""The epoch loop over any iterable of host batches (the reference's
train_one_epoch)."""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable

from ..utils.meters import AverageMeter


def train_one_epoch(state, batches: Iterable[Dict], train_step: Callable, seed: int,
                    epoch: int, *, print_freq: int = 20, schedule: Callable = None,
                    log: Callable = print):
    """Runs train_step over `batches`; returns (state, epoch_losses).

    Losses are read on the host every `print_freq` steps and at the last
    step (each once), and the epoch's losses are the AVERAGES of those
    samples, the reference's AverageMeter semantics, not the last value."""
    batch_time = AverageMeter()
    trackers: Dict[str, AverageMeter] = {}
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
            lr = schedule(state.step - 1) if schedule else float("nan")
            log(f"Epoch: [{epoch:03d}][{it:05d}]\tTime {batch_time.val:.2f} "
                f"({batch_time.avg:.2f})\tLoss {trackers['final_loss'].val:.2f} "
                f"({trackers['final_loss'].avg:.2f})\tlr {lr:.3e}")
    if losses is not None and tracked != it:
        last = track(losses)
    log(f"[Train]: Epoch {epoch:d} finished")
    return state, ({k: m.avg for k, m in trackers.items()} or last)
