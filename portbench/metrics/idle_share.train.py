"""The share of the profiled sub-window of a train run in which no kernel ran
on the card (copies and memsets are not kernels)."""


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "train" or not t or t["window_s"] <= 0 or rec["device"]["platform"] != "gpu":
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100
