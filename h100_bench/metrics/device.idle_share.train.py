"""Share of a train step's untraced time in which the card runs nothing:
1 - (union of the device operations' intervals per step in the profiler
window) / (untraced seconds per step of the same process), %."""


def read(r):
    if not r.trace.ops:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.units / r.s_per_unit)
