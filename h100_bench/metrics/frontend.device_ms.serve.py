"""Device ms per served frame of the operations launched inside the
frontend's ranges (every view's backbone, neck and embedding)."""


def read(r):
    ms = r.device_ms_per_unit(lambda op: op.label.startswith("bench.frontend"))
    return None if ms is None else ms / r.frames_per_unit
