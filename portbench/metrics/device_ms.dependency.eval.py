"""The device time of the kernels launched under the program's
`unav.model.dependency` span (the dependency block, its nested spans
included), per traced eval batch: read from the profiled sub-window's trace
(portbench/spans.py). None where the program has no such span."""


def read(rec):
    t = rec.get("span_trace") or {}
    steps = t.get("count", {}).get("unav.eval.step", 0)
    if rec["kind"] != "eval" or not steps or "unav.model.dependency" not in t["device_s"]:
        return None
    return t["device_s"]["unav.model.dependency"] / steps * 1e3
