"""Device ms per served frame of the operations launched inside the
decoder's ranges (the querent and the fusion decoder with its heads)."""


def read(r):
    ms = r.device_ms_per_unit(lambda op: op.label.startswith("bench.decoder"))
    return None if ms is None else ms / r.frames_per_unit
