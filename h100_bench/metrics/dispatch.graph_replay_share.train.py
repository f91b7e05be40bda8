"""Share of the traced train steps' stage calls that replayed their
forward's CUDA graph, in %: the reader of
``dispatch.graph_replay_share.serve`` (replays over replays plus eager
calls, by the program's counters ``dpft.graph.replays`` and
``dpft.graph.eager``) over the train cell's profiler window. A program
whose train steps count no stage call gives None."""

from harness import spec

_serve = spec.reader("dispatch.graph_replay_share.serve")


def read(r):
    return _serve.read(r)
