"""Model FLOPs of every item completed in the traced run outside the
profiled sub-window, over that time, as a share of the card's dense bf16
peak (989 TFLOP/s, H100 SXM at 700 W) whatever the dtype. The FLOPs per
item are pinned in the configuration's file (portbench/flops.py)."""

from portbench.work import PEAK_BF16


def read(rec):
    if rec["kind"] != "eval" or rec.get("untraced_s", 0) <= 0 or rec["device"]["platform"] != "gpu":
        return None
    return rec["flops_per_item"] * rec["untraced_items"] / rec["untraced_s"] / PEAK_BF16 * 100
