"""The whole forward's share of the card's float32 peak, %: the FLOPs of
a frame from the configuration's shapes (``harness.flops``) times the
frames served in the untraced window, over its seconds, over 67 TFLOP/s."""

from harness import flops


def read(r):
    per_call = flops.forward_flops(r.config, r.input_shapes, r.batch)
    rate = per_call * r.window_units / r.window_s
    return 100.0 * rate / flops.PEAK_F32_FLOPS
