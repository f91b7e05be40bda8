"""Host ms per train step inside the program's span
``dpft.train.optimizer``: AdamW's ``step()``, put in the span by the
optimizer's own step hooks (``training/optimizer.py``), over the profiler
window. ``zero_grad`` and the schedule's step lie outside it."""

from harness import program_spans


def read(r):
    s = program_spans.host_s("dpft.train.optimizer")
    return None if s is None else s * 1e3 / r.units
