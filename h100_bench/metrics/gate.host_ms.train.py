"""Host ms per train step inside the program's span ``dpft.train.gate``
(``training/trainer.py:train_step``: the step's scalars and their
``.tolist()``, where the host waits for the card before the update gate
decides), over the profiler window."""

from harness import program_spans


def read(r):
    s = program_spans.host_s("dpft.train.gate")
    return None if s is None else s * 1e3 / r.units
