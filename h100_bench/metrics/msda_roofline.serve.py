"""Share of its roofline that the deformable attention kernels reach in
serving, %: the least time the card could take for every MSDA call of a
forward (``harness.flops.msda_bound_s``, from the configuration's shapes)
over the device time of the kernels whose names start with ``msda_``."""

from harness import flops


def read(r):
    kernel_s = r.trace.device_s(lambda op: op.name.startswith("msda_"))
    if kernel_s == 0:
        return None
    bound = flops.msda_bound_s(r.config, r.input_shapes, r.batch) * r.units
    return 100.0 * bound / kernel_s
