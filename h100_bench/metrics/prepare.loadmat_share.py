"""Share of the host's prepare time spent reading the tesseract ``.mat``,
%: host seconds inside the processor's ``get_radar_tesseract`` over host
seconds inside its ``prepare_sample``, each summed over the worker
threads by harness wrappers, over the untraced window."""


def read(r):
    read_ms = r.host_ms.get("get_radar_tesseract")
    sample_ms = r.host_ms.get("prepare_sample")
    if not read_ms or not sample_ms or sum(sample_ms) == 0:
        return None
    return 100.0 * sum(read_ms) / sum(sample_ms)
