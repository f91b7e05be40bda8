"""One run of a cell: set-up, the measured window, and the check.

``execute`` is the whole run but for the look for a card and the printing,
so that the test suite can drive it on the CPU at a tiny size.
"""

from __future__ import annotations

import sys
import time
from typing import Any, Callable, Dict

import torch

from harness import spec


def execute(cell: spec.Cell, driver, seconds: float, trace: bool,
            device: torch.device, t0: float,
            phases: Dict[str, float] = None,
            log: Callable[[str], None] = None) -> Dict[str, Any]:
    """Sets ``driver`` up, measures for ``seconds`` (traced or not), drops
    the program and checks what the timed path produced. Returns the
    result line's object; ``checks`` is its last key."""
    log = log or (lambda line: print(line, file=sys.stderr))
    cuda = device.type == "cuda"
    driver.setup()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips}
    breakdown = None
    if not trace:
        values = driver.measure(seconds)
        values["setup_s"] = setup_s
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    else:
        reading = driver.measure_traced(seconds)
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = reading.trace.busy_s
        dev["window_s"] = reading.trace.window_s
        breakdown = reading.trace.breakdown()
    dev["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if cuda else 0)
    log(getattr(driver, "summary", ""))
    phases = {**(phases or {}), **getattr(driver, "phases", {})}
    log(f"run: setup_s {setup_s:.4f} ("
        + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()) + ")")

    driver.finish()
    try:
        numbers = driver.check()
    finally:
        getattr(driver, "close", lambda: None)()
    checks = {name: {"value": value, "limit": cell.limits[name]}
              for name, value in numbers.items()}
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": driver.attempted, "failed": driver.failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result
