"""Device operations (kernels, copies, memsets) the program launches per
served frame: an exact count from the profiler's CUDA activity."""


def read(r):
    if not r.trace.ops:
        return None
    return len(r.trace.ops) / (r.units * r.frames_per_unit)
