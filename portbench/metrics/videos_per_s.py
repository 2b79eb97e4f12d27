"""Videos whose detections reached the host, over the whole window."""


def read(rec):
    if rec["kind"] != "eval":
        return None
    return rec["items"] / rec["window_s"]
