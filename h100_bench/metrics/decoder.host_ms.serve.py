"""Host ms per served frame inside the program's span ``dpft.decoder``
(``models/dpft.py:DPFT.forward``: the querent and the fusion decoder with
its heads), over the profiler window, on the span's own clock."""

from harness import program_spans


def read(r):
    s = program_spans.host_s("dpft.decoder")
    return None if s is None else s * 1e3 / (r.units * r.frames_per_unit)
