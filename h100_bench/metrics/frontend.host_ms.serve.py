"""Host ms per served frame inside the program's span ``dpft.frontend``
(``models/dpft.py:DPFT.features``: every view's backbone, neck and
embedding), over the profiler window, on the span's own clock."""

from harness import program_spans


def read(r):
    s = program_spans.host_s("dpft.frontend")
    return None if s is None else s * 1e3 / (r.units * r.frames_per_unit)
