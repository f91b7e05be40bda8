"""Share of a served frame's untraced time in which the card runs
nothing: 1 - (union of the device operations' intervals per frame in the
profiler window) / (untraced seconds per frame of the same process), %."""


def read(r):
    if not r.trace.ops:
        return None
    busy = r.trace.busy_s / r.units
    return 100.0 * (1.0 - busy / r.s_per_unit)
