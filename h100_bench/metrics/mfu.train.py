"""The whole train step's share of the card's float32 peak, %: the FLOPs
of a step from the configuration's shapes (``harness.flops.step_flops``:
forward and backward) times the steps of the untraced window, over its
seconds, over 67 TFLOP/s."""

from harness import flops


def read(r):
    per_step = flops.step_flops(r.config, r.input_shapes, r.batch)
    rate = per_step * r.window_units / r.window_s
    return 100.0 * rate / flops.PEAK_F32_FLOPS
