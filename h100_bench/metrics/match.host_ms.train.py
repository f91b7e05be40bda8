"""Host ms per train step inside the program's Hungarian matching
(``training/loss.py:Loss.match``: the cost matrices' copy to the host and
the C++ solver), on the host clock of a harness wrapper, over the
untraced window."""


def read(r):
    ms = r.host_ms.get("match")
    if not ms:
        return None
    return sum(ms) / r.window_units
