"""Process start to the first timed step: imports, weights and traffic made,
the program built and its kernels loaded (built on the first run of a
checkout), the warm-up steps."""


def read(rec):
    return rec["setup_s"]
