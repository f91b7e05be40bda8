"""CUDA graphs of the stages of the eval forward and of the train step.

A stage is a module whose ``forward`` carries ``@stage``: each backbone,
neck and embedding, and the fuser (``models/dpft.py`` calls them as
modules). Within one call a stage either runs its ``forward`` as it is
(eagerly: one launch per operation) or replays CUDA graphs that hold all
of its launches: in an eval forward one graph, in a train step two, one
of the stage's forward and one of its backward, which autograd runs as
the stage's node.

A stage replays only where all of these hold; otherwise it runs eagerly,
exactly as without this module:

- its tensor inputs are plain tensors on one CUDA device, and the current
  stream is not being captured already;
- either the module is in eval mode and grad is disabled
  (``inference_mode`` or ``no_grad``), or it is in train mode, grad is
  enabled, some tensor input or parameter requires grad, no saved-tensor
  hook is set (remat's ``torch.utils.checkpoint``, ``save_on_cpu``), the
  call does not run inside a backward (a checkpoint's recompute) and no
  process group is up (data parallelism);
- no ``TorchFunctionMode`` or ``TorchDispatchMode`` is active (such as
  ``FlopCounterMode``), no global module hook is set, and nothing exports,
  compiles or traces (``torch.export``, ``torch.compile``, ``torch.jit``);
- its parameters and buffers are plain tensors, none of its submodules is
  sharded by FSDP or carries a forward hook of its own (hooks on the stage
  itself run around the replay, as around the eager call).

Graphs are kept per key: the structure of the arguments with their
non-tensor values (such as the fuser's level shapes), each tensor input's
shape, strides and dtype, the device, inference mode against ``no_grad``,
the autocast state and dtype, the TF32 and determinism settings, and in
train mode which inputs and parameters require grad. The first call of a
key runs eagerly, which fills the caches that make a tensor on their first
call (level sizes, MSDA normalizers, positional tables, the querent's
grid; none of them drops a tensor, which a graph reads by its address)
and cuDNN's and cuBLAS's state; in train mode its backward does the same
for the backward's kernels. The second runs eagerly on a side stream, the
warm-up PyTorch asks for before a capture, and then captures the stage on
that stream; its result is the warm-up's. Every later call copies its
inputs into the graph's own, replays, and hands back copies of the
graph's outputs (one ``_foreach_copy_`` each way), so that nothing the
caller holds is written by a later replay. A stage keeps ``MAX_GRAPHS``
keys; a new key beyond that drops the least recently used one. No capture
starts while a profiler records (replays do run under one).

In train mode the second call is the step's own forward: its backward
runs eagerly, as the first call's. The graphs of the forward and of the
backward are then captured as ``torch.cuda.make_graphed_callables``
builds them (without its warm-up iterations), and from the third call on
one autograd node replays both: the forward graph when the stage is
called, the backward graph when autograd reaches the node. The backward
graph takes the gradients of the stage's outputs (zeros for an output the
loss does not use) and gives those of its inputs that require grad and of
its parameters, which autograd accumulates into ``.grad`` as it does for
an eager stage (the parameters' as copies, made in one launch a stage). A
step whose backward is skipped leaves the backward graph unreplayed. Two
rules guard the train step:

- No side effect beyond the eager step's. A capture executes nothing, so
  it moves no BatchNorm statistic or counter and no generator offset; the
  warm-up is the step's forward and no extra forward or backward runs. A
  replayed forward draws its dropout masks from the CUDA generator at its
  offset at the replay and advances it as the eager forward does. So
  outputs, gradients, running statistics and the generator's state are
  the eager step's.
- A pool of memory per stage and key. The activations that a forward
  graph saves for its backward stay in its pool until that backward
  replays, after every other stage's forward; the eval graphs, which
  save nothing, share one pool.

A stage whose warm-up made the host wait for the card (torch's sync debug
mode sees it: a pageable copy, ``.item()``) is not captured, since the
capture would raise; a host sync in a backward raises in the capture
before it reaches the driver. Either way the key runs eagerly from then
on. A train replay that would overwrite activations still held for a
backward (the stage called again before the backward of its last replay,
with that graph alive) runs eagerly instead.

Graphs read the stage's parameters and buffers where they were at the
capture. Weights updated in place (an optimizer step, ``load_state_dict``)
are read as they are at each replay. Before each replay the stage compares
the address of every parameter and buffer with the capture's: where one
was rebound or moved (``.to()``, ``load_state_dict(assign=True)``, a new
``Parameter``, a new submodule) its graphs are dropped and its keys start
over with an eager call.

The launch counters of the hand-written kernels' wrappers (the registry
``ops/kernels.py:COUNTED``: ``msda_fwd.launches``,
``window_attn_fwd.launches`` ...) count a replay's launches of those
kernels, forward or backward, as an eager call counts them: a capture
itself launches nothing and counts nothing, and keeps the launches of the
wrappers whose count it moved, which each replay adds. So do the program's
counters that the stage's own code advances (``utils/profiling.py:count``,
such as ``dpft.window_attn.fused``): what a forward's capture counted, in
a tally, each replay counts again, while a profiler records. The program's
counters ``dpft.graph.replays``, ``dpft.graph.captures`` and
``dpft.graph.eager`` count, while a profiler records, the stage calls that
the first three conditions above let graph: those that replay, those that
capture, and those that run eagerly (a capturing call among them: it runs
the warm-up); ``dpft.graph.backward_replays`` counts the backward graphs'
replays. One thread at a time calls the models of a device, on one stream.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import operator
import warnings
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn as nn
from torch.autograd.function import once_differentiable
from torch.autograd.grad_mode import _unsafe_preserve_version_counter
from torch.nn.modules import module as _module

from dpft_tpu_torch.ops import kernels
from dpft_tpu_torch.utils import profiling

GRAPH_DEVICES = ("cuda",)
MAX_GRAPHS = 4      # graphs a stage keeps
_MAX_SEEN = 16      # keys a stage remembers having run once
_CONSTANTS = (int, float, str, type(None), torch.dtype, torch.device)
_PLAIN = (torch.Tensor, nn.Parameter)
_requires_grad = operator.attrgetter("requires_grad")

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


def _autograd_keeps_saved() -> bool:
    """Whether autograd treats this call's saved tensors apart: a
    saved-tensor hook is set (remat's non-reentrant checkpoint,
    ``save_on_cpu``) or the call runs inside a backward (a reentrant
    checkpoint's recompute). A graph would save them as it captured them."""
    return (torch._C._autograd._top_saved_tensors_default_hooks(False)
            is not None or torch._C._current_graph_task_id() != -1)


def _distributed() -> bool:
    """Whether a process group is up: data parallelism (FSDP, DDP), whose
    hooks and collectives a train graph would break."""
    return torch.distributed.is_available() and \
        torch.distributed.is_initialized()


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
            torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled()), tensors


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


def _moved(before: Dict[str, int]) -> Tuple[Tuple[Callable, int], ...]:
    """The counted wrappers whose launches moved since ``before``
    (``kernels.launches()``), each with the launches it made."""
    return tuple((w, w.launches - before.get(name, 0))
                 for name, w in kernels.COUNTED.items()
                 if w.launches != before.get(name, 0))


def _restore(before: Dict[str, int]) -> None:
    for name, w in kernels.COUNTED.items():
        w.launches = before.get(name, 0)


def _advance(launches: Tuple[Tuple[Callable, int], ...],
             counts: Dict[str, int]) -> None:
    """Counts a replay's launches of the counted wrappers (those its
    capture moved) and the program's counts of its capture."""
    for wrapper, n in launches:
        wrapper.launches += n
    for name, n in counts.items():
        profiling.count(name, n)


class _Graph:
    """One captured stage call: the graph, its inputs (indexes and
    buffers, see ``_static_input``) and outputs, the launches of the
    counted wrappers it makes and the program's counts of its capture.
    Inputs and outputs are copied with one ``_foreach_copy_`` each."""

    __slots__ = ("graph", "indexes", "buffers", "outputs", "spec",
                 "launches", "counts")

    def __init__(self, graph, indexes, buffers, outputs, spec, launches,
                 counts):
        self.graph, self.indexes, self.buffers = graph, indexes, buffers
        self.outputs, self.spec, self.launches = outputs, spec, launches
        self.counts = counts

    def free(self) -> bool:
        """Always: an eval replay keeps nothing for later."""
        return True

    def run(self, tensors) -> List[torch.Tensor]:
        """Copies ``tensors`` in, replays, and returns copies of the
        outputs."""
        torch._foreach_copy_(self.buffers, _sources(self.indexes, tensors))
        self.graph.replay()
        _advance(self.launches, self.counts)
        outs = [torch.empty_like(t) for t in self.outputs]
        torch._foreach_copy_(outs, self.outputs)
        return outs

    def replay(self, tensors: List[torch.Tensor],
               params: Optional[List[torch.Tensor]] = None) -> Any:
        return _unflatten(self.spec, iter(self.run(tensors)))


class _Pending:
    """Held by the autograd node of a train replay, for as long as autograd
    may run that node's backward."""

    __slots__ = ("__weakref__",)


class _TrainGraph(_Graph):
    """A train-mode stage call: the graph of its forward (``_Graph``'s
    fields), which outputs are differentiable, and the graph of its
    backward with the output gradients it reads (``grad_outputs``, one per
    differentiable output) and the gradient buffers it writes per input
    (``grads``) and per parameter (``param_grads``; None where there is
    none). ``pending`` refers weakly to the last replay's node."""

    __slots__ = ("differentiable", "backward", "grad_outputs", "grads",
                 "param_grads", "backward_launches", "pending")

    def __init__(self, forward: _Graph, differentiable, backward,
                 grad_outputs, grads, param_grads, backward_launches):
        super().__init__(forward.graph, forward.indexes, forward.buffers,
                         forward.outputs, forward.spec, forward.launches,
                         forward.counts)
        self.differentiable, self.backward = differentiable, backward
        self.grad_outputs, self.grads = grad_outputs, grads
        self.param_grads = param_grads
        self.backward_launches = backward_launches
        self.pending = None

    def free(self) -> bool:
        """Whether no node of an earlier replay may still run its backward
        (which reads the activations that a replay overwrites)."""
        return self.pending is None or self.pending() is None

    def replay(self, tensors: List[torch.Tensor],
               params: Optional[List[torch.Tensor]] = None) -> Any:
        outs = _Replay.apply(self, *tensors, *params)
        return _unflatten(self.spec, iter(outs))

    def run_backward(self, grads) -> Tuple[Optional[torch.Tensor], ...]:
        """Fills the output gradients (zeros where autograd gives none),
        replays the backward graph and returns the gradients of the inputs
        (the graph's buffers, which the next stage's backward copies in)
        and of the parameters: copies made in one launch, which autograd
        puts in ``.grad`` as they are (a buffer of the graph it would
        clone, one launch per parameter)."""
        pairs = list(zip(self.grad_outputs,
                         itertools.compress(grads, self.differentiable)))
        copied = [(b, g) for b, g in pairs if g is not None]
        if copied:
            torch._foreach_copy_(*map(list, zip(*copied)))
        if len(copied) < len(pairs):
            torch._foreach_zero_([b for b, g in pairs if g is None])
        self.backward.replay()
        _advance(self.backward_launches, {})
        profiling.count(profiling.GRAPH_BACKWARD_REPLAYS)
        made = [g for g in self.param_grads if g is not None]
        fresh = [torch.empty_like(g) for g in made]
        if fresh:
            torch._foreach_copy_(fresh, made)
        copies = iter(fresh)
        return (*self.grads, *(None if g is None else next(copies)
                               for g in self.param_grads))


class _Replay(torch.autograd.Function):
    """A train graph's replay as one autograd node: its forward replays the
    forward graph, its backward the backward graph. The arguments are the
    graph, the stage's tensor inputs and the parameters that require grad
    (read in place: passed so that autograd routes their gradients)."""

    @staticmethod
    def forward(ctx, entry: _TrainGraph, *tensors: torch.Tensor):
        outs = entry.run(tensors[:len(entry.buffers)])
        ctx.entry, ctx.pending = entry, _Pending()
        entry.pending = weakref.ref(ctx.pending)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(*(o for o, d in zip(
            outs, entry.differentiable) if not d))
        return tuple(outs)

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads: Optional[torch.Tensor]):
        return (None, *ctx.entry.run_backward(grads))


_FAILED = object()   # a key whose capture raised: it runs eagerly
_side_streams: Dict[torch.device, torch.cuda.Stream] = {}


@contextlib.contextmanager
def _on_side_stream(device: torch.device) -> Iterator[None]:
    """The body on the device's side stream, after everything queued on
    the current one; the current stream then waits for it."""
    current = torch.cuda.current_stream(device)
    side = _side_streams.get(device)
    if side is None:
        side = _side_streams[device] = torch.cuda.Stream(device)
    side.wait_stream(current)
    try:
        with torch.cuda.stream(side):
            yield
    finally:
        current.wait_stream(side)


@contextlib.contextmanager
def _autocast_uncached() -> Iterator[None]:
    """A weight cast that autocast caches would enter a graph as a tensor
    freed when the autocast region ends: in the body the graph casts for
    itself."""
    cache = torch.is_autocast_cache_enabled()
    torch.clear_autocast_cache()
    torch.set_autocast_cache_enabled(False)
    try:
        yield
    finally:
        torch.set_autocast_cache_enabled(cache)


_SYNC_WARNING = "called a synchronizing CUDA operation"   # torch's words


@contextlib.contextmanager
def _sync_debug(mode: str, device: torch.device) -> Iterator[None]:
    """torch's sync debug mode in the body, on a CUDA ``device``:
    ``"warn"`` warns at each operation that makes the host wait for the
    card, ``"error"`` raises there, before the operation reaches the
    driver."""
    if device.type != "cuda":
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def _capture(forward: Callable, module: nn.Module, args: tuple,
             kwargs: dict, spec: Any, tensors: List[torch.Tensor]
             ) -> Tuple[Any, Any]:
    """Runs the stage eagerly on a side stream, the warm-up before a
    capture, and captures it there. Returns the eager run's result and the
    graph (``_FAILED`` where the capture raised)."""
    device = tensors[0].device
    with _on_side_stream(device), _autocast_uncached():
        out = forward(module, *args, **kwargs)
        torch.cuda.synchronize(device)
        entry = _record(forward, module, spec, tensors)
    return out, entry


def _capture_train(forward: Callable, module: nn.Module, args: tuple,
                   kwargs: dict, spec: Any, tensors: List[torch.Tensor],
                   params: List[torch.Tensor]) -> Tuple[Any, Any]:
    """The second train-mode call of a key: the step's own forward, eagerly
    on a side stream (the warm-up), then the graphs of the stage's forward
    and backward captured there (``_record_train``), unless the warm-up
    made the host wait for the card. Returns the eager run's result and
    the graphs (``_FAILED`` where none were captured)."""
    device = tensors[0].device
    with _on_side_stream(device):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with _sync_debug("warn", device):
                out = forward(module, *args, **kwargs)
        synced = []
        for w in caught:
            if str(w.message).startswith(_SYNC_WARNING):
                synced.append(f"{w.filename}:{w.lineno}")
            else:
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno)
        torch.cuda.synchronize(device)
        if synced:
            warnings.warn(f"{type(module).__name__}: no CUDA graph (its "
                          f"forward makes the host wait for the card at "
                          f"{', '.join(synced)}); the stage runs eagerly")
            return out, _FAILED
        with _autocast_uncached():
            entry = _record_train(forward, module, spec, tensors, params)
    return out, entry


# Per device index, the memory pool that every eval graph is captured into,
# and the graphs that hold those pools.
_pools: Dict[int, Any] = {}
_keepers: List[Any] = []
_SHARED = object()


def _held_pool() -> Any:
    """A new memory pool, held for the life of the process by an empty
    graph captured into it: once every graph of a pool is gone, PyTorch's
    allocators (of device and of pinned host memory) refuse a capture into
    it while any of its memory is in use (a cuBLAS workspace made in a
    capture stays)."""
    keeper = torch.cuda.CUDAGraph()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # "The CUDA Graph is empty"
        keeper.capture_begin(capture_error_mode="thread_local")
        keeper.capture_end()
    _keepers.append(keeper)
    return keeper.pool()


def _captured(run: Callable[[], Any], pool: Any = _SHARED
              ) -> Tuple[Any, Any]:
    """A CUDA graph of ``run`` on the current stream, and what ``run``
    returned while it was captured. By default the graph allocates from
    the pool of every eval graph (per device): a replay writes all of its
    scratch before it reads it, its outputs are copied out before the next
    replay, and replays run one after another, so graphs may share their
    scratch (``_held_pool``). ``pool`` None: a pool of its own; else that
    pool."""
    if pool is _SHARED:
        device = torch.cuda.current_device()
        if device not in _pools:
            _pools[device] = _held_pool()
        pool = _pools[device]
    graph = torch.cuda.CUDAGraph()
    graph.capture_begin(pool=pool, capture_error_mode="thread_local")
    try:
        result = run()
    finally:
        graph.capture_end()
    return graph, result


def _inputs(tensors: List[torch.Tensor]):
    """Fixed inputs of a graph (``_static_input``), filled from
    ``tensors``: the indexes, buffers and views."""
    indexes, buffers, views = map(list, zip(*map(_static_input, tensors)))
    with torch.no_grad():
        torch._foreach_copy_(buffers, _sources(indexes, tensors))
    return indexes, buffers, views


def _record(forward: Callable, module: nn.Module, spec: Any,
            tensors: List[torch.Tensor]) -> Any:
    """Captures the stage on the current stream with inputs of its own;
    ``_FAILED`` where that raises. The wrappers' launch counters read after
    it as before it; the program's counts of the capture go to a tally."""
    before = kernels.launches()
    try:
        indexes, buffers, views = _inputs(tensors)
        args, kwargs = _unflatten(spec, iter(views))
        with profiling.tally() as counts:
            graph, result = _captured(
                lambda: forward(module, *args, **kwargs))
        launches = _moved(before)
        outputs: List[torch.Tensor] = []
        out_spec = _flatten(result, outputs)
    except (RuntimeError, _Ungraphable) as exc:
        warnings.warn(f"{type(module).__name__}: no CUDA graph ({exc}); "
                      f"the stage runs eagerly")
        return _FAILED
    finally:
        _restore(before)
    return _Graph(graph, indexes, buffers, outputs, out_spec, launches,
                  counts)


def _record_train(forward: Callable, module: nn.Module, spec: Any,
                  tensors: List[torch.Tensor], params: List[torch.Tensor]
                  ) -> Any:
    """Captures the stage's forward and then its backward on the current
    stream, into a memory pool of their own, with inputs (leaves where the
    caller's require grad), output gradients and input gradients of their
    own; ``_FAILED`` where either raises (a host sync raises before it
    reaches the driver). ``params``: the parameters that require grad.
    Counters as in ``_record``; the backward's own code counts nothing."""
    before = kernels.launches()
    # The capture dispatches the forward's in-place updates (BatchNorm's
    # statistics) but executes none: the warm-up's graph, which saved those
    # tensors, must find them unchanged.
    unchanged = _unsafe_preserve_version_counter(tuple(module.buffers()))
    try:
        indexes, buffers, views = _inputs(tensors)
        views = [v.detach().requires_grad_() if t.requires_grad else v
                 for v, t in zip(views, tensors)]
        args, kwargs = _unflatten(spec, iter(views))
        leaves = [v for v in views if v.requires_grad] + params
        live: List[torch.Tensor] = []   # the outputs that require grad

        def run_forward() -> Any:
            result = forward(module, *args, **kwargs)
            flat: List[torch.Tensor] = []
            _flatten(result, flat)
            live[:] = [t for t in flat if t.requires_grad]
            return result

        device = tensors[0].device
        with _sync_debug("error", device), profiling.tally() as counts:
            graph, result = _captured(run_forward, None)
        launches = _moved(before)
        outputs: List[torch.Tensor] = []
        out_spec = _flatten(result, outputs)
        if not live:
            raise _Ungraphable("no output requires grad")
        grad_outputs = [torch.empty_like(t) for t in live]
        _restore(before)
        with _sync_debug("error", device), torch.autocast(
                device.type, enabled=False):
            backward, grads = _captured(lambda: torch.autograd.grad(
                live, leaves, grad_outputs, allow_unused=True),
                graph.pool())
        backward_launches = _moved(before)
    except (RuntimeError, _Ungraphable) as exc:
        warnings.warn(f"{type(module).__name__}: no CUDA graph of the "
                      f"train step ({exc}); the stage runs eagerly")
        return _FAILED
    finally:
        _restore(before)
        unchanged.__exit__()
    found = iter(grads)
    per_input = [next(found) if t.requires_grad else None for t in tensors]
    forward_graph = _Graph(graph, indexes, buffers,
                           [t.detach() for t in outputs], out_spec,
                           launches, counts)
    return _TrainGraph(forward_graph,
                       [t.requires_grad for t in outputs], backward,
                       grad_outputs, per_input, list(found),
                       backward_launches)


class _Stage:
    """A stage module's graphs, kept on the module as ``_graphs``. A copy
    of the module (``copy.deepcopy``, pickle) starts with none."""

    __slots__ = ("epoch", "ok", "tables", "names", "kinds", "hooks",
                 "addresses", "graphs", "seen")

    def __init__(self):
        self.epoch = -1
        self.ok = False
        self.tables: List[dict] = []     # where each parameter and buffer
        self.names: List[str] = []       # is registered, and whether it is
        self.kinds: List[bool] = []      # a parameter
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
        self.tables, self.names, self.kinds = [], [], []
        self.hooks, self.ok = [], True
        for m in module.modules():
            self.ok = self.ok and not isinstance(m, fsdp)
            if m is not module:
                self.hooks += [m._forward_hooks, m._forward_pre_hooks]
            for table in (m._parameters, m._buffers):
                for name, t in table.items():
                    if t is not None:
                        self.tables.append(table)
                        self.names.append(name)
                        self.kinds.append(table is m._parameters)
                        self.ok = self.ok and type(t) in _PLAIN

    def valid(self, module: nn.Module) -> Optional[List[torch.Tensor]]:
        """The module's parameters and buffers where it may replay now,
        else None; drops every graph where one is no longer where the
        graphs read it."""
        if self.epoch != _epoch:
            self.epoch = _epoch
            self._walk(module)
        if not self.ok or any(self.hooks):
            return None
        try:   # maps, not a comprehension: this runs before every replay
            own = list(map(dict.__getitem__, self.tables, self.names))
            addresses = list(map(torch.Tensor.data_ptr, own))
        except (KeyError, TypeError, RuntimeError):
            self.epoch = -1   # read the tree again
            return None
        if addresses != self.addresses:
            self.graphs.clear()
            self.seen.clear()
            self.addresses = addresses
        return own

    def call(self, forward: Callable, module: nn.Module, args: tuple,
             kwargs: dict, key: Any, tensors: List[torch.Tensor],
             params: Optional[List[torch.Tensor]] = None) -> Any:
        """One call under ``key``: a replay, or an eager run (the first
        of the key, or the second, which captures). ``params``: in train
        mode the parameters that require grad, else None."""
        entry = self.graphs.get(key)
        if isinstance(entry, _Graph) and entry.free():
            self.graphs.move_to_end(key)
            profiling.count(profiling.GRAPH_REPLAYS)
            return entry.replay(tensors, params)
        profiling.count(profiling.GRAPH_EAGER)
        if entry is not None:   # failed, or its activations still held
            return forward(module, *args, **kwargs)
        if key not in self.seen or torch.autograd._profiler_enabled():
            self.seen[key] = None
            self.seen.move_to_end(key)
            if len(self.seen) > _MAX_SEEN:
                self.seen.popitem(last=False)
            return forward(module, *args, **kwargs)
        del self.seen[key]
        profiling.count(profiling.GRAPH_CAPTURES)
        if params is None:
            out, self.graphs[key] = _capture(forward, module, args, kwargs,
                                             key[0], tensors)
        else:
            out, self.graphs[key] = _capture_train(
                forward, module, args, kwargs, key[0][0], tensors, params)
        if len(self.graphs) > MAX_GRAPHS:
            self.graphs.popitem(last=False)
        return out

    def train_call(self, forward: Callable, module: nn.Module, args: tuple,
                   kwargs: dict, key: Any, tensors: List[torch.Tensor],
                   own: List[torch.Tensor]) -> Any:
        """A train-mode call: under ``key`` with which inputs and
        parameters require grad; eager, counting nothing, where none
        does."""
        params = list(itertools.compress(own, self.kinds))
        grads = (tuple(map(_requires_grad, tensors)),
                 tuple(map(_requires_grad, params)))
        if not (any(grads[0]) or any(grads[1])):
            return forward(module, *args, **kwargs)
        return self.call(forward, module, args, kwargs, (key, grads),
                         tensors, list(itertools.compress(params, grads[1])))


def stage(forward: Callable) -> Callable:
    """Makes a module's ``forward`` a stage's: see the module docstring."""

    @functools.wraps(forward)
    def run(module: nn.Module, *args: Any, **kwargs: Any) -> Any:
        found, train = None, False
        if not (module.training or torch.is_grad_enabled()
                or _modes_or_tracing()):
            found = graph_key(args, kwargs)
        elif module.training and torch.is_grad_enabled() and not (
                _modes_or_tracing() or _autograd_keeps_saved()
                or _distributed()):
            found, train = graph_key(args, kwargs), True
        if found is None:   # not on the card, or no eval or train call
            return forward(module, *args, **kwargs)
        state = module.__dict__.get("_graphs")
        if state is None:
            state = module.__dict__["_graphs"] = _Stage()
        own = state.valid(module)
        if own is None:
            profiling.count(profiling.GRAPH_EAGER)
            return forward(module, *args, **kwargs)
        if train:
            return state.train_call(forward, module, args, kwargs, *found,
                                    own)
        return state.call(forward, module, args, kwargs, *found)

    return run
