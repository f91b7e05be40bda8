"""Share of the ResNet trunks' conv -> BatchNorm pairs in the served
frames that ran as one convolution with the BatchNorm folded in, %: the
program's counter ``dpft.bn_fold.folded`` over it plus
``dpft.bn_fold.plain`` (pairs run as a convolution and a BatchNorm), over
the profiler window (``dpft_tpu_torch/models/backbones/resnet.py``; a
replayed stage counts as its capture did). None where neither counted, as
in a program that does not fold."""

from harness import program_spans


def read(r):
    folded = program_spans.counter("dpft.bn_fold.folded")
    plain = program_spans.counter("dpft.bn_fold.plain")
    if folded is None and plain is None:
        return None
    folded, plain = folded or 0, plain or 0
    return 100.0 * folded / (folded + plain)
