"""CUDA graphs of the eval forward's stages.

A stage is a module whose ``forward`` carries ``@stage``: each backbone,
neck and embedding, and the fuser (``models/dpft.py`` calls them as
modules). Within one call a stage either runs its ``forward`` as it is
(eagerly: one launch per operation) or replays one CUDA graph that holds
all of its launches.

A stage replays only where all of these hold; otherwise it runs eagerly,
exactly as without this module:

- its tensor inputs are plain tensors on one CUDA device, and the current
  stream is not being captured already;
- the module is in eval mode and grad is disabled (``inference_mode`` or
  ``no_grad``);
- no ``TorchFunctionMode`` or ``TorchDispatchMode`` is active (such as
  ``FlopCounterMode``), no global module hook is set, and nothing exports,
  compiles or traces (``torch.export``, ``torch.compile``, ``torch.jit``);
- its parameters and buffers are plain tensors, none of its submodules is
  sharded by FSDP or carries a forward hook of its own (hooks on the stage
  itself run around the replay, as around the eager call).

A graph is kept per key: the structure of the arguments with their
non-tensor values (such as the fuser's level shapes), each tensor input's
shape, strides and dtype, the device, inference mode against ``no_grad``,
the autocast state and dtype, and the TF32 settings. The first call of a
key runs eagerly, which fills the caches that make a tensor on their first
call (level sizes, MSDA normalizers, positional tables, the querent's
grid; none of them drops a tensor, which a graph reads by its address)
and cuDNN's and cuBLAS's state. The second runs eagerly on a side
stream, the warm-up PyTorch asks for before a capture, and then captures
the stage on that stream; its result is the warm-up's. Every later call
copies its inputs into the graph's own, replays, and hands back copies of
the graph's outputs (one ``_foreach_copy_`` each way), so that nothing the
caller holds is written by a later replay. The graphs of a device share
one memory pool. A stage keeps ``MAX_GRAPHS``
graphs; a new key beyond that drops the least recently used one. No
capture starts while a profiler records (replays do run under one).

A graph reads the stage's parameters and buffers where they were at the
capture. Weights updated in place (an optimizer step, ``load_state_dict``)
are read as they are at each replay. Before each replay the stage compares
the address of every parameter and buffer with the capture's: where one
was rebound or moved (``.to()``, ``load_state_dict(assign=True)``, a new
``Parameter``, a new submodule) its graphs are dropped and its keys start
over with an eager call.

The launch counters of the hand-written kernels' wrappers
(``ops/deform_attn.py``: ``msda_fwd.launches`` ...) count a replay's
launches of those kernels as an eager call counts them; the capture itself
launches nothing and counts nothing. The program's counters
``dpft.graph.replays``, ``dpft.graph.captures`` and ``dpft.graph.eager``
(``utils/profiling.py``) count, while a profiler records, the stage calls
that the first three conditions above let graph: those that replay, those
that capture, and those that run eagerly (a capturing call among them: it
runs the warm-up). One thread at a time calls the models of a device, on
one stream.
"""

from __future__ import annotations

import collections
import functools
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn as nn
from torch.nn.modules import module as _module

from dpft_tpu_torch.ops import deform_attn
from dpft_tpu_torch.utils import profiling

GRAPH_DEVICES = ("cuda",)
MAX_GRAPHS = 4      # graphs a stage keeps
_MAX_SEEN = 16      # keys a stage remembers having run once
_CONSTANTS = (int, float, str, type(None), torch.dtype, torch.device)
_PLAIN = (torch.Tensor, nn.Parameter)
# The hand-written kernels' wrappers whose ``launches`` a replay advances.
_COUNTED = tuple(deform_attn.LAUNCH_COUNTED.values())

# Bumped by every registration of a module, parameter or buffer anywhere:
# a stage then looks at its own tree again.
_epoch = 0


def _registered(*_: Any) -> None:
    global _epoch
    _epoch += 1


for _register in (_module.register_module_module_registration_hook,
                  _module.register_module_parameter_registration_hook,
                  _module.register_module_buffer_registration_hook):
    _register(_registered)


_TENSOR = object()   # where a tensor stands in an argument structure


class _Ungraphable(Exception):
    pass


def _flatten(tree: Any, tensors: List[torch.Tensor]) -> Any:
    """``tree``'s structure, hashable, with its non-tensor values; appends
    its tensors to ``tensors`` in order."""
    if isinstance(tree, torch.Tensor):
        tensors.append(tree)
        return _TENSOR
    kind = type(tree)
    if kind is tuple or kind is list:
        return kind, tuple(_flatten(x, tensors) for x in tree)
    if kind is dict:
        return kind, tuple((k, _flatten(v, tensors)) for k, v in tree.items())
    if isinstance(tree, _CONSTANTS):
        return tree
    raise _Ungraphable(kind.__name__)


def _unflatten(spec: Any, tensors) -> Any:
    """The structure ``spec`` with the next tensors of ``tensors``."""
    if spec is _TENSOR:
        return next(tensors)
    if type(spec) is not tuple:
        return spec
    kind, items = spec
    if kind is dict:
        return {k: _unflatten(v, tensors) for k, v in items}
    return kind(_unflatten(x, tensors) for x in items)


def _modes_or_tracing() -> bool:
    """Whether something sees the operations one by one (a mode, export,
    compile, jit tracing, a global module hook): a replay would hide them."""
    return bool(torch._C._len_torch_function_stack()
                or torch._C._len_torch_dispatch_stack()
                or torch.compiler.is_compiling()
                or torch.compiler.is_exporting()
                or torch.jit.is_tracing()
                or _module._global_forward_hooks
                or _module._global_forward_pre_hooks)


def graph_key(args: tuple, kwargs: dict
              ) -> Optional[Tuple[Any, List[torch.Tensor]]]:
    """The key of a stage call on ``args`` and ``kwargs`` and its tensor
    inputs in order, or None where the call cannot be graphed: an argument
    of another kind than tensors, containers and constants, no tensor, a
    tensor subclass, or tensors on several devices or on a device that does
    not graph."""
    tensors: List[torch.Tensor] = []
    try:
        spec = _flatten((args, kwargs), tensors)
    except _Ungraphable:
        return None
    if not tensors:
        return None
    device = tensors[0].device
    kind = device.type
    if kind not in GRAPH_DEVICES or any(
            type(t) not in _PLAIN or t.device != device for t in tensors):
        return None
    if kind == "cuda" and torch.cuda.is_current_stream_capturing():
        return None
    autocast = (torch.get_autocast_dtype(kind)
                if torch.is_autocast_enabled(kind) else None)
    layouts = tuple((t.shape, t.stride(), t.dtype) for t in tensors)
    return (spec, layouts, device, torch.is_inference_mode_enabled(),
            autocast, torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32), tensors


def _static_input(x: torch.Tensor):
    """A graph's fixed copy of the input ``x``, in ``x``'s layout: the index
    that selects what is copied (None: all of ``x``), the buffer, and the
    view the graph reads. A dimension that ``x`` broadcasts (stride 0) stays
    a broadcast of one slice."""
    index = tuple(slice(0, 1) if s == 0 and n > 1 else slice(None)
                  for n, s in zip(x.shape, x.stride()))
    if not any(i.stop == 1 for i in index):
        index = None
    src = x if index is None else x[index]
    buffer = torch.empty_strided(src.shape, src.stride(), dtype=x.dtype,
                                 device=x.device)
    return index, buffer, buffer if index is None else buffer.expand(x.shape)


def _sources(indexes: List[Any], tensors: List[torch.Tensor]
             ) -> List[torch.Tensor]:
    return [x if i is None else x[i] for i, x in zip(indexes, tensors)]


class _Graph:
    """One captured stage call: the graph, its inputs (indexes and
    buffers, see ``_static_input``) and outputs, and the launches of the
    counted wrappers it makes. Inputs and outputs are copied with one
    ``_foreach_copy_`` each."""

    __slots__ = ("graph", "indexes", "buffers", "outputs", "spec",
                 "launches")

    def __init__(self, graph, indexes, buffers, outputs, spec, launches):
        self.graph, self.indexes, self.buffers = graph, indexes, buffers
        self.outputs, self.spec, self.launches = outputs, spec, launches

    def replay(self, tensors: List[torch.Tensor]) -> Any:
        torch._foreach_copy_(self.buffers, _sources(self.indexes, tensors))
        self.graph.replay()
        for wrapper, n in zip(_COUNTED, self.launches):
            wrapper.launches += n
        outs = [torch.empty_like(t) for t in self.outputs]
        torch._foreach_copy_(outs, self.outputs)
        return _unflatten(self.spec, iter(outs))


_FAILED = object()   # a key whose capture raised: it runs eagerly
_side_streams: Dict[torch.device, torch.cuda.Stream] = {}


def _capture(forward: Callable, module: nn.Module, args: tuple,
             kwargs: dict, spec: Any, tensors: List[torch.Tensor]
             ) -> Tuple[Any, Any]:
    """Runs the stage eagerly on a side stream, the warm-up before a
    capture, and captures it there. Returns the eager run's result and the
    graph (``_FAILED`` where the capture raised)."""
    device = tensors[0].device
    current = torch.cuda.current_stream(device)
    side = _side_streams.get(device)
    if side is None:
        side = _side_streams[device] = torch.cuda.Stream(device)
    side.wait_stream(current)
    cache = torch.is_autocast_cache_enabled()
    # A weight cast that autocast caches would enter the graph as a tensor
    # freed when the autocast region ends: the graph casts for itself.
    torch.clear_autocast_cache()
    torch.set_autocast_cache_enabled(False)
    try:
        with torch.cuda.stream(side):
            out = forward(module, *args, **kwargs)
            torch.cuda.synchronize(device)
            entry = _record(forward, module, spec, tensors)
    finally:
        torch.set_autocast_cache_enabled(cache)
        current.wait_stream(side)
    return out, entry


_pool = None   # the memory pool that every graph is captured into


def _captured(run: Callable[[], Any]) -> Tuple[Any, Any]:
    """A CUDA graph of ``run`` on the current stream, and what ``run``
    returned while it was captured. Every graph allocates from one pool
    (per device): a replay writes all of its scratch before it reads it,
    its outputs are copied out before the next replay, and replays run one
    after another, so graphs may share their scratch."""
    global _pool
    if _pool is None:
        _pool = torch.cuda.graph_pool_handle()
    graph = torch.cuda.CUDAGraph()
    graph.capture_begin(pool=_pool, capture_error_mode="thread_local")
    try:
        result = run()
    finally:
        graph.capture_end()
    return graph, result


def _record(forward: Callable, module: nn.Module, spec: Any,
            tensors: List[torch.Tensor]) -> Any:
    """Captures the stage on the current stream with inputs of its own;
    ``_FAILED`` where that raises. The wrappers' launch counters read after
    it as before it."""
    before = [w.launches for w in _COUNTED]
    try:
        indexes, buffers, views = map(list, zip(*map(_static_input,
                                                     tensors)))
        torch._foreach_copy_(buffers, _sources(indexes, tensors))
        args, kwargs = _unflatten(spec, iter(views))
        graph, result = _captured(lambda: forward(module, *args, **kwargs))
        launches = [w.launches - n for w, n in zip(_COUNTED, before)]
        outputs: List[torch.Tensor] = []
        out_spec = _flatten(result, outputs)
    except (RuntimeError, _Ungraphable) as exc:
        warnings.warn(f"{type(module).__name__}: no CUDA graph ({exc}); "
                      f"the stage runs eagerly")
        return _FAILED
    finally:
        for wrapper, n in zip(_COUNTED, before):
            wrapper.launches = n
    return _Graph(graph, indexes, buffers, outputs, out_spec, launches)


class _Stage:
    """A stage module's graphs, kept on the module as ``_graphs``. A copy
    of the module (``copy.deepcopy``, pickle) starts with none."""

    __slots__ = ("epoch", "ok", "tables", "names", "hooks", "addresses",
                 "graphs", "seen")

    def __init__(self):
        self.epoch = -1
        self.ok = False
        self.tables: List[dict] = []     # where each parameter and buffer
        self.names: List[str] = []       # is registered
        self.hooks: List[dict] = []      # forward hooks below the root
        self.addresses: Optional[List[int]] = None
        self.graphs: "collections.OrderedDict[Any, Any]" = \
            collections.OrderedDict()
        self.seen: "collections.OrderedDict[Any, None]" = \
            collections.OrderedDict()

    def __deepcopy__(self, memo) -> "_Stage":
        return _Stage()

    def __reduce__(self):
        return _Stage, ()

    def _walk(self, module: nn.Module) -> None:
        """Reads ``module``'s tree: where its tensors are registered, its
        submodules' hooks, and whether it may be graphed at all (plain
        tensors only, no FSDP module)."""
        fsdp = ()
        if torch.distributed.is_available():
            from torch.distributed.fsdp import FSDPModule as fsdp
        self.tables, self.names, self.hooks, self.ok = [], [], [], True
        for m in module.modules():
            self.ok = self.ok and not isinstance(m, fsdp)
            if m is not module:
                self.hooks += [m._forward_hooks, m._forward_pre_hooks]
            for table in (m._parameters, m._buffers):
                for name, t in table.items():
                    if t is not None:
                        self.tables.append(table)
                        self.names.append(name)
                        self.ok = self.ok and type(t) in _PLAIN

    def valid(self, module: nn.Module) -> bool:
        """Whether the module may replay now; drops every graph where a
        parameter or buffer is no longer where the graphs read it."""
        if self.epoch != _epoch:
            self.epoch = _epoch
            self._walk(module)
        if not self.ok or any(self.hooks):
            return False
        try:   # maps, not a comprehension: this runs before every replay
            addresses = list(map(torch.Tensor.data_ptr, map(
                dict.__getitem__, self.tables, self.names)))
        except (KeyError, TypeError, RuntimeError):
            self.epoch = -1   # read the tree again
            return False
        if addresses != self.addresses:
            self.graphs.clear()
            self.seen.clear()
            self.addresses = addresses
        return True

    def call(self, forward: Callable, module: nn.Module, args: tuple,
             kwargs: dict, key: Any, tensors: List[torch.Tensor]) -> Any:
        """One call under ``key``: a replay, or an eager run (the first
        of the key, or the second, which captures)."""
        entry = self.graphs.get(key)
        if isinstance(entry, _Graph):
            self.graphs.move_to_end(key)
            profiling.count(profiling.GRAPH_REPLAYS)
            return entry.replay(tensors)
        profiling.count(profiling.GRAPH_EAGER)
        if entry is _FAILED:
            return forward(module, *args, **kwargs)
        if key not in self.seen or torch.autograd._profiler_enabled():
            self.seen[key] = None
            self.seen.move_to_end(key)
            if len(self.seen) > _MAX_SEEN:
                self.seen.popitem(last=False)
            return forward(module, *args, **kwargs)
        del self.seen[key]
        profiling.count(profiling.GRAPH_CAPTURES)
        out, self.graphs[key] = _capture(forward, module, args, kwargs,
                                         key[0], tensors)
        if len(self.graphs) > MAX_GRAPHS:
            self.graphs.popitem(last=False)
        return out


def stage(forward: Callable) -> Callable:
    """Makes a module's ``forward`` a stage's: see the module docstring."""

    @functools.wraps(forward)
    def run(module: nn.Module, *args: Any, **kwargs: Any) -> Any:
        found = None
        if not (module.training or torch.is_grad_enabled()
                or _modes_or_tracing()):
            found = graph_key(args, kwargs)
        if found is None:   # no eval forward on the card: counts nothing
            return forward(module, *args, **kwargs)
        state = module.__dict__.get("_graphs")
        if state is None:
            state = module.__dict__["_graphs"] = _Stage()
        if state.valid(module):
            return state.call(forward, module, args, kwargs, *found)
        profiling.count(profiling.GRAPH_EAGER)
        return forward(module, *args, **kwargs)

    return run
