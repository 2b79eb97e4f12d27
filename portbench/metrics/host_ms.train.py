"""The mean host time of the program's train step call, until it returns, over
every step of the traced run."""


def read(rec):
    if rec["kind"] != "train" or not rec["host_step_s"]:
        return None
    return sum(rec["host_step_s"]) / len(rec["host_step_s"]) * 1e3
