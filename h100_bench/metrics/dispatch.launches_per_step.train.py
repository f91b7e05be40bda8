"""Device operations (kernels, copies, memsets) per train step, forward,
backward and AdamW: an exact count from the profiler's CUDA activity."""


def read(r):
    if not r.trace.ops:
        return None
    return len(r.trace.ops) / r.units
