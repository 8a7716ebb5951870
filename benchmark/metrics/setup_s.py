"""Seconds from the process's start to the first timed call: the bank
rendered, the session built (kernels loaded, or built on a first run), the
reference captured, the warm-up calls made."""


def read(run):
    return run.setup_s
