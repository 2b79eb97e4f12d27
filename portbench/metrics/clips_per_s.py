"""Clips trained, over the whole window (the device synchronized at its end)."""


def read(rec):
    if rec["kind"] != "train":
        return None
    return rec["items"] / rec["window_s"]
