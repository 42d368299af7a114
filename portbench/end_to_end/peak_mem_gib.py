"""The device memory the window held at its peak, in GiB: the allocator's
`max_memory_allocated`, its peak reset at the window's start."""


def read(run):
    if run.peak_window_bytes is None:
        return None
    return run.peak_window_bytes / 2 ** 30
