"""Runtime calls a proof that block the host until the device is done
(`portbench/trace.py` SYNC_CALLS), from the profiler's trace."""

NEEDS = ()


def read(run):
    if run.trace is None or not run.jobs:
        return None
    return run.trace.host_syncs / run.jobs
