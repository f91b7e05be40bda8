"""Share of its roofline that the shifted-window attention kernel reaches
in serving, %: the least time the card could take for every windowed
attention of a forward's Swin trunks (``harness.flops.
window_attention_bound_s``, from the configuration's shapes) over the
device time of the kernels whose names start with ``window_attn_``. None
where no such kernel ran (Swin blocks that run plain operations, or no
Swin trunk)."""

from harness import flops


def read(r):
    kernel_s = r.trace.device_s(lambda op: op.name.startswith("window_attn_"))
    if kernel_s == 0:
        return None
    bound = flops.window_attention_bound_s(r.config, r.input_shapes,
                                           r.batch) * r.units
    return 100.0 * bound / kernel_s
