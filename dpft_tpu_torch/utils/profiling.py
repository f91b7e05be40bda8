"""Measuring: timings, FLOP and parameter counts, traces, device activity.

Counterpart of dpft_tpu/utils/profiling.py, function by function, for
eager PyTorch on a CUDA card.

Clocks. Every timing function takes the ``device`` its work runs on.
- On a CUDA device it times with CUDA events
  (``torch.cuda.Event(enable_timing=True)``) recorded on that device's
  current stream and waits with ``torch.cuda.synchronize``: a result is the
  time the device took between the events, not the host's. So there is no
  readback round trip to subtract, as the JAX package's ``sync`` needs.
- On the CPU, which only the tests use, it reads ``time.perf_counter``
  around the calls (CPU operators return when they are done). Such a
  result is a CPU time and is never a device metric.

Not ported:
- ``sync`` and ``readback_rtt_ms``: events time the device itself, and
  ``torch.cuda.synchronize`` cannot return before the device is done.
- ``enable_persistent_compilation_cache``: eager PyTorch compiles no
  program; the kernels' build is cached by ``ops/kernels.py``.
- ``memory_analysis`` / ``static_memory_of``: XLA's static buffer
  accounting has no eager counterpart. The peak comes from
  ``torch.cuda.max_memory_allocated`` after
  ``torch.cuda.reset_peak_memory_stats`` instead.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Sequence
from typing import Tuple, Union

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

Device = Union[str, torch.device]

# The Chrome trace that ``trace`` writes into its directory.
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def _on(device: torch.device) -> Iterator[None]:
    """Makes ``device`` current for the events of a CUDA device."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            yield
    else:
        yield


def _drain(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Clock:
    """ms of the work submitted to ``device`` between ``start`` and
    ``stop``: CUDA events on a card, ``time.perf_counter`` on the CPU.
    ``stop`` waits for the device."""

    def __init__(self, device: torch.device):
        self.device = device
        self._begin: Any = None

    def start(self) -> None:
        if self.device.type == "cuda":
            self._begin = torch.cuda.Event(enable_timing=True)
            self._begin.record()
        else:
            self._begin = time.perf_counter()

    def stop(self) -> float:
        if self.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            torch.cuda.synchronize(self.device)
            return self._begin.elapsed_time(end)
        return (time.perf_counter() - self._begin) * 1e3


def _per_call_ms(fn: Callable, args: Sequence, repetitions: int,
                 device: torch.device) -> np.ndarray:
    clock = _Clock(device)
    timings = np.zeros(repetitions)
    for i in range(repetitions):
        clock.start()
        fn(*args)
        timings[i] = clock.stop()
    return timings


def benchmark(fn: Callable, *args, device: Device, repetitions: int = 100,
              warmup: int = 10) -> Tuple[float, float]:
    """(mean_ms, std_ms) of ``fn(*args)`` over ``repetitions`` calls after
    ``warmup``; each call is timed alone (the device is drained after it).

    The std is the sample std (ddof=1), as the JAX package's. CUDA events
    on a card, ``time.perf_counter`` on the CPU (see the module docstring).
    """
    device = torch.device(device)
    with _on(device):
        for _ in range(warmup):
            fn(*args)
        _drain(device)
        timings = _per_call_ms(fn, args, repetitions, device)
    return float(timings.mean()), float(timings.std(ddof=1))


def benchmark_medians(fn: Callable, *args, device: Device,
                      repetitions: int = 10, warmup: int = 3, runs: int = 5
                      ) -> Tuple[float, float]:
    """(median_of_medians_ms, half_spread_ms) over ``runs`` runs of
    ``repetitions`` calls each, timed as in :func:`benchmark`: the median of
    the runs' medians and half their min-max spread."""
    device = torch.device(device)
    with _on(device):
        for _ in range(warmup):
            fn(*args)
        _drain(device)
        medians = np.asarray([
            float(np.median(_per_call_ms(fn, args, repetitions, device)))
            for _ in range(runs)])
    return (float(np.median(medians)),
            float((medians.max() - medians.min()) / 2.0))


def benchmark_pipelined(fn: Callable, argsets: Sequence[Sequence], *,
                        device: Device, repetitions: int = 60,
                        warmup: int = 6) -> float:
    """ms per call with the calls enqueued back to back, with no fence
    between them, cycling through ``argsets`` (distinct inputs, so no call
    can reuse another's). One pair of CUDA events (``time.perf_counter`` on
    the CPU) spans the whole loop; the result is that time over
    ``repetitions``: the device's steady throughput when the host keeps
    ahead of it, else the host's."""
    device = torch.device(device)
    with _on(device):
        for i in range(max(warmup, len(argsets))):
            fn(*argsets[i % len(argsets)])
        _drain(device)
        clock = _Clock(device)
        clock.start()
        for i in range(repetitions):
            fn(*argsets[i % len(argsets)])
        return clock.stop() / repetitions


def cost_analysis(fn: Callable, *args, **kwargs) -> Dict[str, int]:
    """FLOPs of one call of ``fn(*args, **kwargs)``, run once under
    ``torch.utils.flop_counter.FlopCounterMode``: 2 x the multiply-adds of
    every convolution and matrix product, forward and backward, and the
    formulas registered on custom operators (``dpft::msda_*``).
    Elementwise work, normalisations and optimizer updates are not counted.
    The JAX package's ``bytes_accessed`` (XLA's static count) has no eager
    counterpart and is left out."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return {"flops": counter.get_total_flops()}


def parameter_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


@contextlib.contextmanager
def trace(log_dir: str, device: Device) -> Iterator[torch.profiler.profile]:
    """Profiles the body with ``torch.profiler`` (CPU activity, and CUDA
    activity on a card) and writes a Chrome trace, ``log_dir/trace.json``,
    for Perfetto or ``chrome://tracing``. The device is drained before the
    trace ends. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _drain(device)
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@dataclasses.dataclass
class DeviceActivity:
    """What calls put on the card, per call, from one profiled window."""

    launches: float              # kernels, copies and memsets
    busy_ms: float               # time at least one of them was running
    kernel_ms: Dict[str, float]  # each one's own time, by name


def busy_time(spans: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals: work that overlaps
    (two streams at once) counts once."""
    busy, end = 0.0, -math.inf
    for start, stop in sorted(spans):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy


def kernel_name(name: str) -> str:
    """A device event's name without return type, namespaces, template
    arguments and parameters: ``msda_fwd_kernel``, ``Memcpy HtoD``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    name = name.split("<")[0].split("(")[0].strip()
    return name.rsplit("::", 1)[-1][:40]


def device_activity(fn: Callable[[], Any], reps: int = 1, *,
                    device: Device) -> DeviceActivity:
    """Launches, device-busy ms and each kernel's ms per call of ``fn``,
    from one ``torch.profiler`` window over ``reps`` calls after one call
    outside it. The window records CUDA activity only: the host's
    operators would add nothing to these counts and make reading the
    window several times slower. The device's own times do not depend on
    the profiler, but the host's do: take end-to-end times with it off, and
    before it, since once used the profiler stays attached to the process
    and every later launch costs the host more. The busy share of a call
    is ``busy_ms`` over its time with tracing off.

    Only a CUDA device has launches to count: another device raises."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"device_activity counts a CUDA card's launches; "
                         f"got {device}")
    with _on(device):
        fn()
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize(device)
    spans: List[Tuple[float, float]] = []
    names: Dict[str, float] = {}
    for event in prof.events():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = (event.time_range.start, event.time_range.end)  # us
        spans.append(span)
        name = kernel_name(event.name)
        names[name] = names.get(name, 0.0) + (span[1] - span[0]) / reps / 1e3
    return DeviceActivity(launches=len(spans) / reps,
                          busy_ms=busy_time(spans) / reps / 1e3,
                          kernel_ms=names)
