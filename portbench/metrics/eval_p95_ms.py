"""The 95th percentile of every window batch's latency: from the call of the
eval step on it until its detections are readable on the host."""

import statistics


def read(rec):
    if rec["kind"] != "eval" or len(rec["latencies_s"]) < 2:
        return None
    return statistics.quantiles(rec["latencies_s"], n=100, method="inclusive")[94] * 1e3
