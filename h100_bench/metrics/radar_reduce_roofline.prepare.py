"""Share of their roofline that the radar kernels reach in prepare, %:
the least time the card could take for both planes of every frame
(``harness.flops.radar_bound_s``: the cube read once for each plane, the
planes written) over the device time of the kernels whose names start
with ``radar_``."""

from harness import flops

RANGE_ROWS = (4, 252)


def read(r):
    kernel_s = r.trace.device_s(lambda op: op.name.startswith("radar_"))
    if kernel_s == 0:
        return None
    frames = r.units * r.frames_per_unit
    bound = flops.radar_bound_s(r.extra["cube"], RANGE_ROWS) * frames
    return 100.0 * bound / kernel_s
