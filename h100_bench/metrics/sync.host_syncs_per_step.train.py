"""The program's host syncs per train step: its counter
``dpft.host_syncs`` (each site where the host waits for the card: copies
to the host, pageable copies to the device, ``.tolist()``), over the
steps of the profiler window."""

from harness import program_spans


def read(r):
    n = program_spans.counter("dpft.host_syncs")
    return None if n is None else n / r.units
