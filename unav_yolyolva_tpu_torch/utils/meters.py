"""Running-average meter (the reference's AverageMeter)."""

from __future__ import annotations


class AverageMeter:
    def __init__(self):
        self.val = self.avg = self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
