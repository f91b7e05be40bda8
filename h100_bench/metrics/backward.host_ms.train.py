"""Host ms per train step inside the program's span
``dpft.train.backward`` (``training/trainer.py:train_step``: the main
thread in ``.backward()`` while autograd's thread launches), over the
profiler window."""

from harness import program_spans


def read(r):
    s = program_spans.host_s("dpft.train.backward")
    return None if s is None else s * 1e3 / r.units
