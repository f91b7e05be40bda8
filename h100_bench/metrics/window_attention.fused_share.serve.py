"""Share of the Swin blocks' window attentions in the served frames that
went through the kernel, %: the program's counter
``dpft.window_attn.fused`` over it plus ``dpft.window_attn.plain`` (calls
through the plain operations), over the profiler window
(``dpft_tpu_torch/models/backbones/swin.py``; a replayed stage counts as
its capture did). None where neither counted."""

from harness import program_spans


def read(r):
    fused = program_spans.counter("dpft.window_attn.fused")
    plain = program_spans.counter("dpft.window_attn.plain")
    if fused is None and plain is None:
        return None
    fused, plain = fused or 0, plain or 0
    return 100.0 * fused / (fused + plain)
