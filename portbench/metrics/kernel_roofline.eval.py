"""The kernels' share of their roofline in one eval step: the sum over the
step's kernel entry point calls of each call's least time (portbench/work.py)
over the sum of its time alone on the card (portbench/kernels.py)."""

from portbench.work import least_seconds


def read(rec):
    if rec["kind"] != "eval" or not rec.get("kernels"):
        return None
    least = sum(least_seconds(c) * c.count for c, _ in rec["kernels"])
    spent = sum(s * c.count for c, s in rec["kernels"])
    return least / spent * 100
