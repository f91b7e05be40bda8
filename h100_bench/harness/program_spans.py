"""What the program's own spans and counters (``dpft_tpu_torch/utils/
profiling.py``) hold after a traced window: the totals of the last
profiler session, which is the window.

The program is imported inside these functions, as everywhere in the
harness. A program without spans (one older than ``span_totals`` in its
measuring module) gives None, and so do spans never opened.
"""

from __future__ import annotations

from typing import Optional


def _read(name: str) -> dict:
    from dpft_tpu_torch.utils import profiling
    read = getattr(profiling, name, None)
    return read() if read is not None else {}


def host_s(name: str) -> Optional[float]:
    """Host seconds inside the span ``name``, summed over its calls and
    threads, or None where it was never opened."""
    span = _read("span_totals").get(name)
    return span["host_s"] if span and span["calls"] else None


def counter(name: str) -> Optional[int]:
    """The counter ``name``, or None where nothing counted it."""
    return _read("counters").get(name)
