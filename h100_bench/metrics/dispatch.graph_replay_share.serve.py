"""Share of the served frames' stage calls that replayed a CUDA graph, in
%: the program's counters ``dpft.graph.replays`` over replays plus
``dpft.graph.eager`` (stage calls that ran eagerly, a capture included),
over the profiler window (``dpft_tpu_torch/models/graphs.py``)."""

from harness import program_spans


def read(r):
    replays = program_spans.counter("dpft.graph.replays")
    eager = program_spans.counter("dpft.graph.eager")
    if replays is None and eager is None:
        return None
    replays, eager = replays or 0, eager or 0
    return 100.0 * replays / (replays + eager)
