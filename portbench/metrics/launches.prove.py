"""CUDA kernels the device ran a proof, from the profiler's trace."""

NEEDS = ()


def read(run):
    if run.trace is None or not run.trace.launches or not run.jobs:
        return None
    return run.trace.launches / run.jobs
