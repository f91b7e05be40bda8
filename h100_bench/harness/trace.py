"""The traced run: ranges the harness opens around the program's modules,
one ``torch.profiler`` window, and what is read from its trace.

Ranges are ``record_function`` annotations named ``bench.<layer>...``,
opened by forward pre-hooks and closed by forward hooks on modules of the
program, or by the harness around its own calls (the copies in and out,
the matching). Nothing inside the program is changed. Each device
operation (kernel, copy, memset) is attributed to the innermost range
that was open on the host thread that launched it, found through the
launch's correlation id; a launch from another thread outside every range
takes the traffic generator's name for that thread (``backward`` for
autograd's engine, ``prepare_worker`` for the processor's pool), one from
the main thread outside every range ``host``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class ModuleRanges:
    """Forward hooks that open the range ``label`` around each module's
    forward. ``remove()`` takes them off again."""

    def __init__(self, modules: Sequence[Tuple[str, torch.nn.Module]]):
        self._handles = []
        self._open: List[contextlib.AbstractContextManager] = []
        for label, module in modules:
            self._handles.append(module.register_forward_pre_hook(
                self._enter(label)))
            self._handles.append(module.register_forward_hook(self._exit))

    def _enter(self, label: str) -> Callable:
        def hook(module, args):
            rf = torch.profiler.record_function(label)
            rf.__enter__()
            self._open.append(rf)
        return hook

    def _exit(self, module, args, output):
        self._open.pop().__exit__(None, None, None)

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


def dpft_ranges(model: torch.nn.Module) -> ModuleRanges:
    """The frontend (per view: backbone, neck, embedding) and the decoder
    (querent, fuser) of a DPFT model, each in a range of its own."""
    mods: List[Tuple[str, torch.nn.Module]] = []
    for part in ("backbones", "necks", "embeddings"):
        for view, module in getattr(model, part).items():
            mods.append((f"bench.frontend.{view}.{part}", module))
    mods.append(("bench.decoder.querent", model.querent))
    mods.append(("bench.decoder.fuser", model.fuser))
    return ModuleRanges(mods)


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_us: float
    dur_us: float
    label: str


@dataclasses.dataclass
class Trace:
    ops: List[DeviceOp]
    window_s: float       # host clock over the traced window
    busy_s: float         # union of the device operations' intervals
    start_us: float       # the window's bounds on the trace's clock
    end_us: float

    def device_s(self, pred: Callable[[DeviceOp], bool]) -> float:
        return sum(op.dur_us for op in self.ops if pred(op)) / 1e6

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        by_name: Dict[str, float] = {}
        for op in self.ops:
            by_name[op.name] = by_name.get(op.name, 0.0) + op.dur_us / 1e6
        gaps: Dict[str, float] = {}
        end = self.start_us
        for op in sorted(self.ops, key=lambda o: o.start_us):
            if op.start_us > end:
                gaps[op.label] = gaps.get(op.label, 0.0) + (
                    op.start_us - end) / 1e6
            end = max(end, op.start_us + op.dur_us)
        if self.end_us > end:
            gaps["host.after_last_op"] = (self.end_us - end) / 1e6
        def ranked(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                    ][:top]
        return {"device_ops": ranked(by_name), "idle_gaps": ranked(gaps)}


def busy_time(spans: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy


def kernel_name(name: str) -> str:
    """A device operation's name without return type, namespaces,
    template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    name = name.split("<")[0].split("(")[0].strip()
    return name.rsplit("::", 1)[-1][:48] or "unnamed"


def read_chrome_trace(path: str, window_s: float,
                      other_thread: str = "other_thread") -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges: Dict[int, List[Tuple[float, float, str]]] = {}
    launches: Dict[int, Tuple[float, int]] = {}
    device = []
    window = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args") or {}
        if cat == "user_annotation" and e["name"].startswith("bench."):
            start = float(e["ts"])
            span = (start, start + float(e["dur"]), e["name"])
            if e["name"] == "bench.window":
                window = span
            ranges.setdefault(e["tid"], []).append(span)
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (float(e["ts"]), e["tid"])
        elif cat in DEVICE_CATS:
            device.append(e)
    if window is None:
        raise RuntimeError("the trace holds no bench.window range")
    main_tid = next(tid for tid, spans in ranges.items()
                    if any(s[2] == "bench.window" for s in spans))
    ops = []
    for e in device:
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        launch = launches.get((e.get("args") or {}).get("correlation"))
        label = "host"
        if launch is not None:
            lts, tid = launch
            if tid != main_tid:
                label = other_thread
            inner = None
            for start, stop, name in ranges.get(tid, []):
                if start <= lts <= stop and name != "bench.window" and (
                        inner is None or start >= inner[0]):
                    inner = (start, name)
            if inner is not None:
                label = inner[1]
        ops.append(DeviceOp(kernel_name(e["name"]), ts, dur, label))
    busy = busy_time([(o.start_us, o.start_us + o.dur_us) for o in ops])
    return Trace(ops, window_s, busy / 1e6, window[0], window[1])


def traced(fn: Callable[[], int], device: torch.device,
           other_thread: str = "other_thread",
           tmpdir: Optional[str] = None) -> Tuple[Trace, int]:
    """Runs ``fn`` (which returns how many units of work it did) inside
    one profiler window and a ``bench.window`` range; returns the trace
    and the count. ``other_thread`` labels launches from threads other
    than the caller's. The Chrome trace goes to a temporary file under
    ``tmpdir`` (default ``$TMPDIR``), removed after reading."""
    from torch.profiler import ProfilerActivity, profile

    def drain() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    drain()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.window"):
            units = fn()
            drain()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", dir=tmpdir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return read_chrome_trace(path, window_s, other_thread), units
    finally:
        os.remove(path)


@contextlib.contextmanager
def span(label: str) -> Iterator[None]:
    with torch.profiler.record_function(label):
        yield
