"""Seconds from the start of the process to the end of the warm-up:
importing, building or loading the kernels, making the key and inputs from
the seed, and the warm-up jobs."""


def read(run):
    return run.setup_s
