"""The device time of the kernels launched under the program's
`unav.dependency.expand` (the expanding conv and ReLU) and
`unav.dependency.squeeze` (the sum and the squeezing conv) spans, per
traced eval batch, every level: read from the profiled sub-window's trace
(portbench/spans.py). None where the program has no such spans."""

NAMES = ("unav.dependency.expand", "unav.dependency.squeeze")


def read(rec):
    t = rec.get("span_trace") or {}
    steps = t.get("count", {}).get("unav.eval.step", 0)
    if rec["kind"] != "eval" or not steps or not all(n in t["device_s"] for n in NAMES):
        return None
    return sum(t["device_s"][n] for n in NAMES) / steps * 1e3
