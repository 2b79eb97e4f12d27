"""The MHCA kernel's share of its roofline at the dependency block's
one-head shapes: the sum over the block's 12 calls of an eval step
(portbench/work_dependency.py:block_calls) of each call's least time
(portbench/work.py) over the sum of its time alone on the card
(portbench/kernels.py)."""

from portbench.work import least_seconds


def read(rec):
    if rec["kind"] != "eval" or not rec.get("dependency_kernels"):
        return None
    least = sum(least_seconds(c) * c.count for c, _ in rec["dependency_kernels"])
    spent = sum(s * c.count for c, s in rec["dependency_kernels"])
    return least / spent * 100
