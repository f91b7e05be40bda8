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

Spans and counters (no counterpart in the JAX package). The program opens
``span(name)`` at the boundaries of its layers and calls ``count(name)``
where the host waits for the card (``dpft.host_syncs``), at each call of
a graphed stage (``GRAPH_REPLAYS`` / ``_CAPTURES`` / ``_EAGER`` /
``_BACKWARD_REPLAYS`` below) and
at each Swin block's window attention (``WINDOW_ATTN_FUSED`` / ``_PLAIN``)
and at each ResNet trunk's call (``BN_FOLD_FOLDED`` / ``_PLAIN`` /
``_REFOLDS``).
Both record only while a
``torch.profiler`` records on the calling thread (``trace`` below, or any
other profiler window); otherwise a span is one check and a shared
do-nothing context manager, with no range, clock read or allocation. A
recording span opens ``torch.profiler.record_function(name)``, so that it
is a range of the Chrome trace on the device trace's clock, reads
``time.perf_counter_ns`` at both ends and adds its duration to its name's
totals (``span_totals``): the calls, the host seconds, and the self
seconds, the part of its interval that no child span on the same thread
covers. The totals and counters cover one profiler session: they are
zeroed when the main thread first finds the profiler on after it was off,
and when ``trace`` starts. Worker threads do not see the caller's profiler:
a pool hands them the caller's state with ``in_thread(enabled())``. Their
totals count; their ranges reach no trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import threading
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List
from typing import Tuple, Union

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

Device = Union[str, torch.device]

# The Chrome trace that ``trace`` writes into its directory, and the
# span totals and counters of the same window beside it.
TRACE_FILE = "trace.json"
SPANS_FILE = "spans.json"


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


def benchmark(fn: Callable, *args, device: Device, repetitions: int = 100,
              warmup: int = 10) -> Tuple[float, float]:
    """(mean_ms, std_ms) of ``fn(*args)`` over ``repetitions`` calls after
    ``warmup``; each call is timed alone (the device is drained after it).

    The std is the sample std (ddof=1), as the JAX package's. CUDA events
    on a card, ``time.perf_counter`` on the CPU (see the module docstring).
    """
    device = torch.device(device)
    timings = np.zeros(repetitions)
    with _on(device):
        for _ in range(warmup):
            fn(*args)
        _drain(device)
        for i in range(repetitions):
            if device.type == "cuda":
                begin = torch.cuda.Event(enable_timing=True)
                begin.record()
                fn(*args)
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                torch.cuda.synchronize(device)
                timings[i] = begin.elapsed_time(end)
            else:
                begin = time.perf_counter()
                fn(*args)
                timings[i] = (time.perf_counter() - begin) * 1e3
    return float(timings.mean()), float(timings.std(ddof=1))


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
    for Perfetto or ``chrome://tracing``, in which the program's spans are
    ranges and each outermost span carries its unit's ``id`` in ``args``;
    and the body's span totals and counters, ``log_dir/spans.json``
    (``{"spans": span_totals(), "counters": counters()}``). The device is
    drained before the trace ends. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        _start_session()
        try:
            yield prof
            _drain(device)
        finally:
            _end_session()
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    _annotate(path)
    with open(os.path.join(log_dir, SPANS_FILE), "w") as f:
        json.dump({"spans": span_totals(), "counters": counters()}, f,
                  indent=1)


# -- spans and counters -------------------------------------------------------

_profiling = torch.autograd._profiler_enabled
_lock = threading.Lock()
_local = threading.local()   # per thread: open spans, carried state
_session = False             # set and cleared by the main thread only
_carried = 0                 # threads inside ``in_thread(True)``
_totals: Dict[str, List[int]] = {}     # name -> [calls, host ns, self ns]
_counts: Dict[str, int] = {}
_ids: Dict[Tuple[int, str], List[Any]] = {}  # (native tid, name) -> ids
_sequence: Dict[str, int] = {}


class _Off:
    """What ``span`` and ``in_thread`` give while nothing records."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _on_main() -> bool:
    return threading.current_thread() is threading.main_thread()


def _start_session() -> None:
    global _session
    with _lock:
        for table in (_totals, _counts, _ids, _sequence):
            table.clear()
        _session = True


def _end_session() -> None:
    global _session
    _session = False


def enabled() -> bool:
    """Whether spans and counters record on the calling thread. The main
    thread opens a session when it finds the profiler on and none open,
    and ends it when it finds the profiler off; no other thread does
    either."""
    if _profiling():
        if not _session and _on_main():
            _start_session()
        return True
    if _session and _on_main():
        _end_session()
        return False
    return _carried > 0 and getattr(_local, "carried", 0) > 0


class _Carried:
    def __enter__(self) -> None:
        global _carried
        with _lock:
            _carried += 1
        _local.carried = getattr(_local, "carried", 0) + 1

    def __exit__(self, *exc) -> bool:
        global _carried
        _local.carried -= 1
        with _lock:
            _carried -= 1
        return False


def in_thread(on: bool):
    """A context manager for a worker thread's body that records there as
    the thread that handed the work out does: ``on`` is that thread's
    ``enabled()``, read when it handed the work out."""
    return _Carried() if on else _OFF


class _Span:
    __slots__ = ("name", "id", "range", "start", "covered")

    def __init__(self, name: str, id: Any):
        self.name, self.id = name, id

    def __enter__(self) -> "_Span":
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if not stack:  # outermost on its thread: the unit's id
            with _lock:
                unit = self.id
                if unit is None:
                    unit = _sequence.get(self.name, 0)
                    _sequence[self.name] = unit + 1
                _ids.setdefault((threading.get_native_id(), self.name),
                                []).append(unit)
        stack.append(self)
        self.covered = 0
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        took = time.perf_counter_ns() - self.start
        self.range.__exit__(*exc)
        stack = _local.stack
        if stack and stack[-1] is self:
            stack.pop()
        else:
            stack.remove(self)
        if stack:
            stack[-1].covered += took
        with _lock:
            totals = _totals.setdefault(self.name, [0, 0, 0])
            totals[0] += 1
            totals[1] += took
            totals[2] += took - self.covered
        return False


def span(name: str, id: Any = None):
    """A context manager around one layer's work. While this thread
    records, it is a range ``name`` of the profiler's trace and adds to
    ``span_totals()[name]``; an outermost span carries ``id`` (by default
    its sequence number among the session's spans of that name) into the
    range's ``args`` of the trace ``trace`` writes. A name that starts with
    ``.`` goes on from the name of the innermost span open on this thread
    (``.stage1`` under ``a.backbone``: ``a.backbone.stage1``; with none
    open, the name without its dot). Otherwise it does nothing."""
    if _profiling() or _carried or _session:
        if enabled():
            if name.startswith("."):
                stack = getattr(_local, "stack", None)
                name = stack[-1].name + name if stack else name[1:]
            return _Span(name, id)
    return _OFF


# Counters of the stages' CUDA graphs (``models/graphs.py``), per stage
# call of an eval forward or a train step on the card (eval mode with grad
# off, or train mode with grad on; no mode or tracing): one that replayed
# its graph, one that captured it, and one that ran eagerly (a capturing
# call included); and per replay of a train call's backward graph.
GRAPH_REPLAYS = "dpft.graph.replays"
GRAPH_CAPTURES = "dpft.graph.captures"
GRAPH_EAGER = "dpft.graph.eager"
GRAPH_BACKWARD_REPLAYS = "dpft.graph.backward_replays"
# Counters of the Swin blocks' window attention
# (``models/backbones/swin.py``): calls through the kernel
# ``dpft::window_attn_fwd`` and calls through the plain operations.
WINDOW_ATTN_FUSED = "dpft.window_attn.fused"
WINDOW_ATTN_PLAIN = "dpft.window_attn.plain"
# Counters of the ResNet trunks' conv -> BatchNorm pairs
# (``models/backbones/resnet.py``), per pair of a call on the card: run as
# one convolution with the BatchNorm folded in, run as a convolution and a
# BatchNorm; and per pair folded again (outside any graph, before a call).
BN_FOLD_FOLDED = "dpft.bn_fold.folded"
BN_FOLD_PLAIN = "dpft.bn_fold.plain"
BN_FOLD_REFOLDS = "dpft.bn_fold.refolds"


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` while this thread records; inside
    ``tally()`` to the tally instead."""
    tallied = getattr(_local, "tally", None)
    if tallied is not None:
        tallied[name] = tallied.get(name, 0) + n
    elif (_profiling() or _carried) and enabled():
        with _lock:
            _counts[name] = _counts.get(name, 0) + n


@contextlib.contextmanager
def tally() -> Iterator[Dict[str, int]]:
    """Yields a dict that collects every ``count`` this thread makes in the
    body, whether or not anything records, in place of the counters: what
    a CUDA graph's capture counted, for each replay to count again
    (``models/graphs.py``)."""
    outer = getattr(_local, "tally", None)
    _local.tally = counted = {}
    try:
        yield counted
    finally:
        _local.tally = outer


def span_totals() -> Dict[str, Dict[str, float]]:
    """Per span name, over the current or last profiler session: ``calls``,
    ``host_s`` (the host seconds between entry and exit, summed over calls
    and threads) and ``self_s`` (the part that no child span covers)."""
    with _lock:
        return {name: {"calls": calls, "host_s": host / 1e9,
                       "self_s": own / 1e9}
                for name, (calls, host, own) in _totals.items()}


def counters() -> Dict[str, int]:
    """Every counter of the current or last profiler session."""
    with _lock:
        return dict(_counts)


def step_span(optimizer: torch.optim.Optimizer, name: str
              ) -> torch.optim.Optimizer:
    """Puts every ``optimizer.step()`` in the span ``name``, through the
    optimizer's own step hooks, whoever calls it. Returns the optimizer."""
    opened: List[Any] = []

    def enter(opt, args, kwargs) -> None:
        while opened:  # a step that raised left its span open
            opened.pop().__exit__(None, None, None)
        opened.append(span(name))
        opened[-1].__enter__()

    def leave(opt, args, kwargs) -> None:
        if opened:
            opened.pop().__exit__(None, None, None)

    optimizer.register_step_pre_hook(enter)
    optimizer.register_step_post_hook(leave)
    return optimizer


def _annotate(path: str) -> None:
    """Writes the unit id of every outermost span into its range's ``args``
    in the Chrome trace at ``path``: the k-th range of a name that no other
    ``dpft.`` range encloses on its thread takes the k-th id recorded there
    (``record_function`` carries no arguments into the trace)."""
    with _lock:
        ids = {key: list(units) for key, units in _ids.items()}
    if not ids:
        return
    with open(path) as f:
        trace = json.load(f)
    by_thread: Dict[Any, List[Dict[str, Any]]] = {}
    for e in trace.get("traceEvents", []):
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and str(e.get("name", "")).startswith("dpft.")):
            by_thread.setdefault(e.get("tid"), []).append(e)
    for tid, events in by_thread.items():
        end = -math.inf
        seen: Dict[str, int] = {}
        for e in sorted(events, key=lambda e: (e["ts"], -e.get("dur", 0))):
            if e["ts"] < end:
                continue  # enclosed by an earlier outermost range
            end = e["ts"] + e.get("dur", 0)
            units = ids.get((tid, e["name"]), [])
            k = seen.get(e["name"], 0)
            seen[e["name"]] = k + 1
            if k < len(units):
                e.setdefault("args", {})["id"] = units[k]
    with open(path, "w") as f:
        json.dump(trace, f)


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
