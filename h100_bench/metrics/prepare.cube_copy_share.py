"""Share of the host's prepare time spent copying the tesseract to the
card, %: host seconds inside the program's span
``dpft.prepare.radar.to_device`` over host seconds inside its
``dpft.prepare.sample``, each summed over the worker threads, over the
profiler window (one prepare call)."""

from harness import program_spans


def read(r):
    copy = program_spans.host_s("dpft.prepare.radar.to_device")
    sample = program_spans.host_s("dpft.prepare.sample")
    if copy is None or not sample:
        return None
    return 100.0 * copy / sample
