"""The eval forward's stages as CUDA graphs (``dpft_tpu_torch/models/
graphs.py``), on the CPU at the benchmark's tiny size
(``h100_bench/tests/tiny_kradar.json``).

- Where a stage may not replay (the CPU as it is, grad on, train mode,
  ``FlopCounterMode``, ``torch.export``) the model runs eagerly and gives
  the same bits as its plain forward, and nothing is captured.
- The policy is driven on the CPU by letting the CPU graph and standing in
  for the capture (``_Emulated``: a replay runs the captured call again on
  the graph's own inputs into the graph's own outputs): the first call of
  a key runs eagerly, the second captures, later ones replay; replays give
  the plain forward's bits, read weights updated in place, hand back
  outputs that the next replay leaves alone, and are dropped where a
  parameter is moved or rebound.
- The module tree and the state_dict keys are the plain model's, and the
  benchmark's hooks on the stage modules fire around each replay.
- The key tells apart batch size, dtype, autocast, inference mode and the
  level shapes; a stage keeps at most ``MAX_GRAPHS`` graphs.
- The per-layer readers ``dispatch.graph_replay_share.serve`` and
  ``.train`` read the counters.
- The train step (train mode, grad on): where its path engages and where
  the stage stays eager; its key; one eager call, one capture, then
  replays of a forward and a backward graph, whose outputs, gradients,
  BatchNorm buffers and generator state equal the eager step's over
  several steps with dropout on; a step the gate skips; a rebound weight;
  the counters. On the CPU the capture is emulated as above, and what the
  emulated capture's run changes (BatchNorm buffers, the generator) is put
  back, since a capture executes nothing.
"""

import contextlib
import copy
import gc
import json
import os.path as osp
import pickle
import sys
import warnings
import weakref

import numpy as np
import pytest
import torch
import torch.nn as nn

from dpft_tpu_torch.evaluation.evaluator import forward_flops, to_device
from dpft_tpu_torch.export import export_forward
from dpft_tpu_torch.models import dpft, graphs
from dpft_tpu_torch.models.backbones import (ConvNeXtBackbone, RegNetBackbone,
                                             ResNetBackbone, SwinBackbone)
from dpft_tpu_torch.models.embeddings import MultiLevelSinusoidalEmbedding
from dpft_tpu_torch.models.fusers import IMPFusion
from dpft_tpu_torch.models.layers.common import init_parameters
from dpft_tpu_torch.models.necks import FPN
from dpft_tpu_torch.ops import deform_attn, kernels, radar_reduce, window_attn
from dpft_tpu_torch.training.trainer import CentralizedTrainer
from dpft_tpu_torch.utils import profiling
from dpft_tpu_torch.utils.example import example_targets
from test_full_model_parity import make_batch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
BENCH = osp.join(ROOT, "h100_bench")
CONFIG = osp.join(BENCH, "tests", "tiny_kradar.json")
CPU = torch.device("cpu")
STAGE_CLASSES = (ResNetBackbone, ConvNeXtBackbone, SwinBackbone,
                 RegNetBackbone, FPN, MultiLevelSinusoidalEmbedding,
                 IMPFusion)
STAGES = 3 * 3 + 1      # per view backbone, neck, embedding; the fuser


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def config():
    with open(CONFIG) as f:
        return json.load(f)


def build(config):
    model = dpft.from_config(copy.deepcopy(config))
    return init_parameters(model, torch.Generator().manual_seed(0)).eval()


def batch(B=2, seed=0, dtype=None):
    out = to_device(make_batch(np.random.default_rng(seed)), CPU)
    out = {k: v[:B] for k, v in out.items()}
    if dtype is not None:
        out = {k: v.to(dtype) if v.is_floating_point() else v
               for k, v in out.items()}
    return out


@contextlib.contextmanager
def unwrapped():
    """Every stage class with its own ``forward``, without ``@stage``."""
    saved = {cls: cls.forward for cls in STAGE_CLASSES}
    try:
        for cls in STAGE_CLASSES:
            cls.forward = cls.forward.__wrapped__
        yield
    finally:
        for cls, forward in saved.items():
            cls.forward = forward


def plain(model, inputs):
    """The model's plain forward under ``inference_mode``."""
    with unwrapped(), torch.inference_mode():
        return model(inputs)


def graph_counters():
    return {k: v for k, v in profiling.counters().items()
            if k.startswith("dpft.graph.")}


def same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def states(model):
    return [m.__dict__.get("_graphs") for m in model.modules()
            if m.__dict__.get("_graphs") is not None]


def captured(model):
    return sum(isinstance(g, graphs._Graph) for s in states(model)
               for g in s.graphs.values())


class _Emulated:
    """Stands in for a CUDA graph on the CPU: a replay runs the captured
    call again on the graph's own inputs, in the grad mode of the capture,
    and writes its result into the graph's own outputs. A train forward's
    run keeps what it made for the backward's run (``_record_train``)."""

    def __init__(self, run, result):
        self.run, self.outputs = run, []
        self.grad = torch.is_grad_enabled()
        graphs._flatten(result, self.outputs)

    def pool(self):
        return ("emulated", id(self))

    def replay(self):
        counted = kernels.launches()
        fresh = []
        # No Python ran: the graph's own counts.
        with profiling.tally(), torch.set_grad_enabled(self.grad):
            graphs._flatten(self.run(), fresh)
        with torch.no_grad():
            for out, new in zip(self.outputs, fresh):
                out.copy_(new)
        graphs._restore(counted)  # no Python ran


@pytest.fixture
def cpu_graphs(monkeypatch):
    """Lets the CPU graph, with the capture emulated; counts captures."""
    made = []

    def captured_run(run, pool=None):
        result = run()
        made.append(_Emulated(run, result))
        return made[-1], result

    def capture(forward, module, args, kwargs, spec, tensors):
        out = forward(module, *args, **kwargs)
        return out, graphs._record(forward, module, spec, tensors)

    def capture_train(forward, module, args, kwargs, spec, tensors, params):
        out = forward(module, *args, **kwargs)
        # A capture executes nothing: put back what the emulation's runs
        # change.
        buffers = [(b, b.clone()) for b in module.buffers()]
        rng = torch.get_rng_state()
        entry = graphs._record_train(forward, module, spec, tensors, params)
        torch.set_rng_state(rng)
        with torch.no_grad(), graphs._unsafe_preserve_version_counter(
                tuple(b for b, _ in buffers)):
            for b, value in buffers:
                b.copy_(value)
        return out, entry

    monkeypatch.setattr(graphs, "GRAPH_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(graphs, "_captured", captured_run)
    monkeypatch.setattr(graphs, "_capture", capture)
    monkeypatch.setattr(graphs, "_capture_train", capture_train)
    return made


# -- where a stage runs eagerly --------------------------------------------

def counted(model, inputs):
    """The forward under ``FlopCounterMode``, whose module tracker needs
    the parameters not to require grad (``forward_flops``)."""
    params = list(model.parameters())
    try:
        for p in params:
            p.requires_grad_(False)
        with torch.utils.flop_counter.FlopCounterMode(display=False):
            return model(inputs)
    finally:
        for p in params:
            p.requires_grad_(True)


@pytest.mark.parametrize("mode", ["cpu", "grad", "train", "flops",
                                  "export"])
def test_ungraphed_paths_run_the_plain_forward(config, mode, monkeypatch):
    model = build(config)
    inputs = batch()
    want = plain(model, inputs)
    if mode != "cpu":   # the CPU may graph: only the condition holds it
        monkeypatch.setattr(graphs, "GRAPH_DEVICES", ("cuda", "cpu"))
    # A second call would capture and a third replay, were it not for
    # the condition (an export traces once per call).
    for _ in range(2 if mode == "export" else 3):
        if mode == "cpu":
            with torch.inference_mode():
                got = model(inputs)
        elif mode == "grad":
            got = {k: v.detach() for k, v in model(inputs).items()}
        elif mode == "train":
            with torch.no_grad():
                got = model.train()(inputs)
            model.eval()
        elif mode == "flops":
            with torch.inference_mode():
                flops = forward_flops(model, inputs)
                got = counted(model, inputs)
        else:
            got = export_forward(model, inputs).module()(inputs)
        if mode != "train":   # train-mode dropout draws its own masks
            same(got, want)
    if mode == "flops":
        with unwrapped(), torch.inference_mode():
            assert flops == forward_flops(model, inputs)
    assert captured(model) == 0


# -- the policy, on the emulation ------------------------------------------

def test_first_call_eager_second_captures_later_ones_replay(config,
                                                            cpu_graphs):
    model = build(config)
    inputs = batch()
    want = plain(model, inputs)
    for call in range(4):
        with torch.inference_mode():
            got = model(inputs)
        same(got, want)
        assert captured(model) == (0 if call == 0 else STAGES)
    assert len(cpu_graphs) == STAGES


def test_replay_under_no_grad_and_inference_mode(config, cpu_graphs):
    model = build(config)
    inputs = batch()
    want = plain(model, inputs)
    for _ in range(3):
        with torch.no_grad():
            same(model(inputs), want)
        with torch.inference_mode():
            same(model(inputs), want)
    assert captured(model) == 2 * STAGES   # one key per mode


def test_held_outputs_are_not_overwritten(config, cpu_graphs):
    model = build(config)
    first, second = batch(seed=0), batch(seed=1)
    with torch.inference_mode():
        for _ in range(2):
            model(first)
        held = model(first)                 # a replay
        kept = {k: v.clone() for k, v in held.items()}
        other = model(second)               # the next replay
    same(held, kept)
    same(other, plain(model, second))
    assert not any(torch.equal(held[k], other[k]) for k in held)


def test_replay_reads_weights_updated_in_place(config, cpu_graphs):
    model = build(config)
    inputs = batch()
    with torch.inference_mode():
        for _ in range(3):
            model(inputs)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.9).add_(0.01)
        model.load_state_dict({k: v + 0.001 for k, v in
                               model.state_dict().items()
                               if v.is_floating_point()}, strict=False)
    assert captured(model) == STAGES
    with torch.inference_mode():
        got = model(inputs)
    assert captured(model) == STAGES       # replayed, not captured again
    same(got, plain(model, inputs))


@pytest.mark.parametrize("how", ["to", "assign", "parameter", "submodule"])
def test_moved_or_rebound_tensors_drop_the_graphs(config, cpu_graphs, how):
    model = build(config)
    inputs = batch()
    with torch.inference_mode():
        for _ in range(3):
            model(inputs)
    assert captured(model) == STAGES
    with torch.no_grad():
        if how == "to":
            model.to(torch.float64)
            inputs = batch(dtype=torch.float64)
        elif how == "assign":
            model.load_state_dict({k: v.clone() * 1.01 if v.is_floating_point()
                                   else v.clone()
                                   for k, v in model.state_dict().items()},
                                  assign=True)
        elif how == "parameter":
            conv = model.necks["radar_bev"].fpn.layer_blocks[0][0]
            conv.weight = nn.Parameter(conv.weight * 1.01)
        else:
            conv = model.necks["radar_bev"].fpn.layer_blocks[0][0]
            new = nn.Conv2d(conv.in_channels, conv.out_channels, 3,
                            padding=1)
            new.load_state_dict(conv.state_dict())
            new.weight.mul_(1.01)
            model.necks["radar_bev"].fpn.layer_blocks[0][0] = new
    want = plain(model, inputs)
    with torch.inference_mode():
        got = model(inputs)   # eager: graphs were dropped where stale
    same(got, want)
    with torch.inference_mode():
        for _ in range(2):
            same(model(inputs), want)
    # The embeddings hold no parameter or buffer: under assign they keep
    # their graphs; under to(float64) the inputs' dtype makes new keys.
    dropped = {"to": STAGES, "assign": STAGES - 3}.get(how, 1)
    assert len(cpu_graphs) == STAGES + dropped


def test_hooks_inside_a_stage_hold_it_eager(config, cpu_graphs):
    model = build(config)
    inputs = batch()
    with torch.inference_mode():
        for _ in range(3):
            model(inputs)
    fired = []
    conv = model.backbones["radar_front"].body.conv1
    handle = conv.register_forward_hook(lambda m, a, out: fired.append(1))
    try:
        with torch.inference_mode():
            same(model(inputs), plain(model, inputs))
    finally:
        handle.remove()
    assert len(fired) == 2          # the call above and ``plain``
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.inference_mode():
            model(inputs)
    assert graph_counters() == {profiling.GRAPH_REPLAYS: STAGES}


def test_a_failed_capture_leaves_the_key_eager(config, monkeypatch):
    def fail(run):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(graphs, "GRAPH_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(graphs, "_captured", fail)
    monkeypatch.setattr(graphs, "_capture", lambda f, m, a, k, s, t: (
        f(m, *a, **k), graphs._record(f, m, s, t)))
    model = build(config)
    inputs = batch()
    want = plain(model, inputs)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with torch.inference_mode():
            for _ in range(4):
                same(model(inputs), want)
    assert len([w for w in caught if "no CUDA graph" in str(w.message)]
               ) == STAGES
    assert captured(model) == 0


def test_replays_count_the_wrapped_kernels_launches(cpu_graphs):
    class Launching(nn.Module):
        @graphs.stage
        def forward(self, x):
            deform_attn.msda_fwd.launches += 2
            return {"y": x * 2}

    module, x = Launching().eval(), torch.ones(3)
    before = deform_attn.msda_fwd.launches
    with torch.inference_mode():
        for _ in range(5):
            assert torch.equal(module(x)["y"], x * 2)
    # 5 calls of 2 launches: eager, warm-up (the capture counts none),
    # three replays.
    assert deform_attn.msda_fwd.launches - before == 10


@pytest.mark.parametrize("module, name", [
    (deform_attn, "msda_fwd"), (deform_attn, "msda_bwd"),
    (deform_attn, "msda_mm_fwd"), (deform_attn, "msda_mm_bwd"),
    (window_attn, "window_attn_fwd"), (radar_reduce, "radar_reduce_ra"),
    (radar_reduce, "radar_reduce_ea")])
def test_registry_holds_each_kernel_wrapper(module, name):
    """The one list of launch-counted wrappers (``ops/kernels.py``) holds
    the function its module exports, and its reset zeroes it."""
    wrapper = getattr(module, name)
    assert kernels.COUNTED[name] is wrapper
    before = kernels.launches()
    try:
        wrapper.launches += 3
        assert kernels.launches()[name] == before[name] + 3
        kernels.reset_launches()
        assert wrapper.launches == 0 == kernels.launches()[name]
    finally:
        for other, n in before.items():
            kernels.COUNTED[other].launches = n


def test_replays_advance_only_the_wrappers_their_capture_moved(cpu_graphs):
    class Launching(nn.Module):
        @graphs.stage
        def forward(self, x):
            window_attn.window_attn_fwd.launches += 1
            return {"y": x + 1}

    module, x = Launching().eval(), torch.ones(3)
    with torch.inference_mode():
        for _ in range(2):
            module(x)
    graph, = (g for g in module._graphs.graphs.values()
              if isinstance(g, graphs._Graph))
    assert graph.launches == ((window_attn.window_attn_fwd, 1),)


def test_counters_and_no_capture_under_the_profiler(config, cpu_graphs):
    from torch.profiler import ProfilerActivity, profile

    model = build(config)
    inputs = batch()
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.inference_mode():
            for _ in range(3):
                model(inputs)
    assert captured(model) == 0
    assert graph_counters() == {profiling.GRAPH_EAGER: 3 * STAGES}
    with torch.inference_mode():
        model(inputs)                        # captures
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.inference_mode():
            for _ in range(2):
                model(inputs)
    assert graph_counters() == {profiling.GRAPH_REPLAYS: 2 * STAGES}


def test_deepcopy_and_pickle_start_without_graphs(config, cpu_graphs):
    model = build(config)
    inputs = batch()
    with torch.inference_mode():
        for _ in range(3):
            model(inputs)
    for twin in (copy.deepcopy(model), pickle.loads(pickle.dumps(model))):
        assert all(not s.graphs for s in states(twin))
        with torch.inference_mode():
            same(twin(inputs), plain(model, inputs))
    assert captured(model) == STAGES


# -- the tree, the keys, the hooks -----------------------------------------

def test_module_tree_and_state_dict_keys_are_unchanged(config, cpu_graphs):
    sys.path.insert(0, BENCH)
    try:
        from harness.trace import dpft_ranges
    finally:
        sys.path.remove(BENCH)
    from torch.profiler import ProfilerActivity, profile

    model = build(config)
    names = [n for n, _ in model.named_modules()]
    keys = list(model.state_dict())
    inputs = batch()
    with torch.inference_mode():
        for _ in range(3):
            model(inputs)
    assert [n for n, _ in model.named_modules()] == names
    assert list(model.state_dict()) == keys
    ranges = dpft_ranges(model)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with torch.inference_mode():
                model(inputs)
    finally:
        ranges.remove()
    seen = {e.name for e in prof.events() if e.name.startswith("bench.")}
    views = ("camera_mono", "radar_bev", "radar_front")
    want = {f"bench.frontend.{v}.{part}" for v in views
            for part in ("backbones", "necks", "embeddings")}
    assert seen == want | {"bench.decoder.querent", "bench.decoder.fuser"}
    assert graph_counters() == {profiling.GRAPH_REPLAYS: STAGES}


def key(args, **kwargs):
    found = graphs.graph_key(args, kwargs)
    assert found is not None
    return found[0]


def test_graph_key_tells_calls_apart(config, monkeypatch):
    monkeypatch.setattr(graphs, "GRAPH_DEVICES", ("cuda", "cpu"))
    x = torch.zeros(2, 3, 8, 8)
    levels = ((8, 8), (4, 4))
    base = ((x, levels),)
    with torch.inference_mode():
        k = key(base)
        assert key(((x.clone(), levels),)) == k     # values do not count
        assert key(((x[:1], levels),)) != k         # batch size
        assert key(((x.double(), levels),)) != k    # dtype
        assert key(((x, ((8, 8), (2, 2))),)) != k   # level shapes
        assert key(((x.contiguous(memory_format=torch.channels_last),
                     levels),)) != k                # strides
        with torch.autocast("cpu", dtype=torch.bfloat16):
            assert key(base) != k                   # autocast
    with torch.no_grad():
        assert key(base) != k                       # no_grad, not inference
    assert graphs.graph_key((x, object()), {}) is None
    assert graphs.graph_key((levels,), {}) is None  # no tensor
    monkeypatch.setattr(graphs, "GRAPH_DEVICES", ("cuda",))
    assert graphs.graph_key(base, {}) is None       # the CPU does not graph


def test_broadcast_inputs_keep_their_layout(cpu_graphs):
    class Stage(nn.Module):
        @graphs.stage
        def forward(self, x):
            return x + 1

    module = Stage().eval()
    grid = torch.arange(6.0).reshape(3, 2)
    with torch.inference_mode():
        for B in (4, 4, 4):
            x = grid[None].expand(B, -1, -1)
            got = module(x)
            assert torch.equal(got, x + 1)
    (entry,) = module._graphs.graphs.values()
    (buffer,) = entry.buffers
    assert buffer.shape == (1, 3, 2)
    assert buffer.expand(x.shape).stride() == x.stride()


def test_a_stage_keeps_at_most_max_graphs(cpu_graphs):
    class Stage(nn.Module):
        @graphs.stage
        def forward(self, x):
            return x * 3

    module = Stage().eval()
    with torch.inference_mode():
        for n in range(1, 40):
            for _ in range(3):
                assert torch.equal(module(torch.ones(n)), torch.full((n,), 3.0))
    state = module._graphs
    assert len(state.graphs) == graphs.MAX_GRAPHS
    assert len(state.seen) <= graphs._MAX_SEEN
    with torch.inference_mode():
        assert list(state.graphs) == [key((torch.ones(n),))
                                      for n in range(36, 40)]


def test_level_size_tables_stay_where_a_graph_reads_them(config,
                                                          cpu_graphs):
    """Under backend "mm" the fuser's graph reads ``_level_sizes``'s table
    by its address and holds no reference to it: however many other level
    shapes the process sees after the capture, the table stays alive and
    in place, and the replays give the plain forward."""
    mm = copy.deepcopy(config)
    mm["model"]["fuser"]["pallas_msda"] = "mm"
    model, inputs = build(mm), batch()
    want = plain(model, inputs)
    with torch.inference_mode():
        for _ in range(2):
            model(inputs)                   # eager, then the capture
    assert captured(model) == STAGES
    info = deform_attn._level_sizes.cache_info()
    assert info.currsize > 0
    tables = [deform_attn._level_sizes(shapes, CPU)
              for shapes in {tuple(map(tuple, s))
                             for _, s in model.features(inputs)}]
    kept = [(weakref.ref(t), t.data_ptr()) for t in tables]
    del tables
    for n in range(1, 2 * 64 + 1):
        deform_attn._level_sizes(((n, n + 1),), CPU)
    gc.collect()
    assert all(ref() is not None and ref().data_ptr() == address
               for ref, address in kept)
    with torch.inference_mode():
        for _ in range(2):
            same(model(inputs), want)       # replays


def test_every_graph_captures_into_one_pool(monkeypatch):
    """The eval graphs share one memory pool per device, which an empty
    graph that the process keeps holds: every capture names it. A train
    graph's forward takes a pool of its own (None), and its backward that
    pool."""
    pools = []
    handles = iter(range(10))

    class Graph:
        def capture_begin(self, pool=None, capture_error_mode=None):
            self.id = (next(handles), 0) if pool is None else pool
            pools.append(pool)

        def capture_end(self):
            pass

        def pool(self):
            return self.id

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(graphs, "_pools", {})
    monkeypatch.setattr(graphs, "_keepers", [])
    for n in range(3):
        graph, result = graphs._captured(lambda: n)
        assert isinstance(graph, Graph) and result == n
    assert pools == [None] + [(0, 0)] * 3    # the keeper, then the graphs
    assert [k.pool() for k in graphs._keepers] == [(0, 0)]
    graphs._captured(lambda: 0, None)
    graphs._captured(lambda: 0, (7, 0))
    assert pools[4:] == [None, (7, 0)]


# -- the train step ---------------------------------------------------------

def trained(model, inputs, backward=True):
    """One train-mode forward of ``model`` and, with ``backward``, the
    backward of the sum of its outputs; returns the outputs, detached."""
    out = model.train()(inputs)
    if backward:
        sum(v.float().sum() for v in out.values()).backward()
    return {k: v.detach() for k, v in out.items()}


def train_graphs(model):
    return sum(isinstance(g, graphs._TrainGraph) for s in states(model)
               for g in s.graphs.values())


def grads(model):
    return {k: None if p.grad is None else p.grad.clone()
            for k, p in model.named_parameters()}


def same_grads(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert (a[k] is None) == (b[k] is None), k
        if a[k] is not None:
            assert torch.equal(a[k], b[k]), k


def same_state(a, b):
    same(dict(a.named_parameters()), dict(b.named_parameters()))
    same(dict(a.named_buffers()), dict(b.named_buffers()))


class _PassThrough(torch.overrides.TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


def _fsdp(module):
    """``module`` as FSDP2's ``fully_shard`` leaves its class."""
    from torch.distributed.fsdp import FSDPModule
    cls = type(module)
    module.__class__ = type(f"FSDP{cls.__name__}", (FSDPModule, cls), {})


@pytest.mark.parametrize("case", ["eval_grad", "no_grad", "frozen", "remat",
                                  "fsdp", "group", "mode", "hook"])
def test_where_the_train_path_engages(config, cpu_graphs, monkeypatch,
                                      case):
    """Train mode with grad on graphs every stage but where the call
    observes what a graph would hide or break: eval mode, no grad, nothing
    that requires grad, remat's checkpoint (the backbones), an FSDP
    module, a process group (data parallelism), a mode, a hook inside the
    stage."""
    model, inputs = build(config), batch()
    if case == "frozen":
        model.requires_grad_(False)
    elif case == "remat":
        model.remat = True
    elif case == "fsdp":
        _fsdp(model.necks["radar_bev"].fpn.layer_blocks[0])
    elif case == "group":
        monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    elif case == "hook":
        model.backbones["radar_front"].body.conv1.register_forward_hook(
            lambda m, a, out: None)
    for _ in range(3):
        torch.manual_seed(0)
        if case == "eval_grad":
            model.eval()(inputs)
        elif case == "no_grad":
            with torch.no_grad():
                trained(model, inputs, backward=False)
        elif case == "frozen":
            trained(model, inputs, backward=False)
        elif case == "mode":
            with _PassThrough():
                trained(model, inputs)
        else:
            trained(model, inputs)
        model.zero_grad(set_to_none=True)
    want = {"remat": STAGES - 3, "fsdp": STAGES - 1,
            "hook": STAGES - 1}.get(case, 0)
    assert train_graphs(model) == want
    assert captured(model) == want


def test_a_train_key_differs_from_an_eval_key(config, cpu_graphs):
    model, inputs = build(config), batch()
    for _ in range(3):
        trained(model, inputs)
    want = plain(model.eval(), inputs)
    with torch.inference_mode():
        for _ in range(3):
            same(model(inputs), want)
    for state in states(model):
        kinds = sorted(type(g).__name__ for g in state.graphs.values())
        assert kinds == ["_Graph", "_TrainGraph"]
        (train_key,) = [k for k, g in state.graphs.items()
                        if isinstance(g, graphs._TrainGraph)]
        eval_key = next(k for k in state.graphs if k != train_key)
        assert train_key[0][:3] == eval_key[:3]    # the call's structure
        assert train_key[0] != eval_key            # no inference mode


def test_train_calls_eager_then_capture_then_replay(config, cpu_graphs):
    from torch.profiler import ProfilerActivity, profile

    model, inputs = build(config), batch()
    trained(model, inputs)
    assert captured(model) == 0 and not cpu_graphs
    trained(model, inputs)
    assert train_graphs(model) == STAGES
    assert len(cpu_graphs) == 2 * STAGES          # a forward, a backward
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            trained(model, inputs)
    assert graph_counters() == {profiling.GRAPH_REPLAYS: 2 * STAGES,
                                profiling.GRAPH_BACKWARD_REPLAYS:
                                    2 * STAGES}
    assert len(cpu_graphs) == 2 * STAGES


def test_replayed_train_steps_equal_the_eager_steps(config, cpu_graphs):
    """Five steps of the train CLI's step and AdamW, dropout on, from the
    same weights and generator: from the third on the stages replay.
    Losses, outputs, every gradient, every parameter and buffer and the
    generator state after each step equal the eager model's. A forward
    with no backward (the gate's skipped step) between them changes
    nothing."""
    trainer = CentralizedTrainer.from_config(config)
    eager, graphed = build(config), build(config)
    optimizers = [trainer.optimizer_factory(m.parameters())
                  for m in (eager, graphed)]
    for step in range(5):
        inputs = batch(seed=step % 2)
        targets = to_device(example_targets(config, B=2, seed=step), CPU)
        results = []
        for model, optimizer in zip((eager, graphed), optimizers):
            torch.manual_seed(step)
            with unwrapped() if model is eager else contextlib.nullcontext():
                if step == 3:   # no backward
                    out = model.train()(inputs)
                    scalars = {k: v.detach() for k, v in out.items()}
                    del out
                else:
                    scalars = trainer.train_step(model, inputs, targets)
            results.append((scalars, grads(model), torch.get_rng_state()))
            if step != 3:
                optimizer.step()
                optimizer.zero_grad(set_to_none=True)
        (want, want_grads, want_rng), (got, got_grads, got_rng) = results
        if step == 3:
            same(got, want)
        else:
            assert got == want
        same_grads(got_grads, want_grads)
        assert torch.equal(got_rng, want_rng)
        same_state(graphed, eager)
    assert train_graphs(graphed) == STAGES
    assert len(cpu_graphs) == 2 * STAGES


def test_a_held_replay_makes_the_next_call_eager(config, cpu_graphs):
    """While autograd may still run the backward of a replay, the next
    call of its key runs eagerly (a replay would overwrite the activations
    that backward reads); both backwards then give the eager gradients."""
    from torch.profiler import ProfilerActivity, profile

    eager, graphed = build(config), build(config)
    inputs = [batch(seed=0), batch(seed=1)]
    for _ in range(2):
        trained(graphed, inputs[0])
    graphed.zero_grad(set_to_none=True)
    results = []
    for model in (eager, graphed):
        torch.manual_seed(5)
        with unwrapped() if model is eager else contextlib.nullcontext():
            with profile(activities=[ProfilerActivity.CPU]):
                outs = [model.train()(x) for x in inputs]
                sum(v.float().sum() for out in outs
                    for v in out.values()).backward()
        results.append((graph_counters(), grads(model)))
    assert results[1][0] == {profiling.GRAPH_REPLAYS: STAGES,
                             profiling.GRAPH_EAGER: STAGES,
                             profiling.GRAPH_BACKWARD_REPLAYS: STAGES}
    same_grads(results[1][1], results[0][1])


def test_rebinding_a_weight_drops_both_graphs(config, cpu_graphs):
    model, inputs = build(config), batch()
    for _ in range(2):
        trained(model, inputs)
    assert train_graphs(model) == STAGES
    conv = model.necks["radar_bev"].fpn.layer_blocks[0][0]
    conv.weight = nn.Parameter(conv.weight.detach() * 1.01)
    model.zero_grad(set_to_none=True)
    trained(model, inputs)            # that stage eager: its graphs dropped
    assert train_graphs(model) == STAGES - 1
    assert conv.weight.grad is not None
    want = conv.weight.grad.clone()
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        torch.manual_seed(0)
        trained(model, inputs)        # captures, then replays
    assert train_graphs(model) == STAGES
    assert len(cpu_graphs) == 2 * (STAGES + 1)
    assert conv.weight.grad.shape == want.shape


def test_train_replays_count_both_graphs_launches(cpu_graphs):
    class Sampled(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            deform_attn.msda_fwd.launches += 2
            return x * 2

        @staticmethod
        def backward(ctx, g):
            deform_attn.msda_bwd.launches += 3
            return g * 2

    class Launching(nn.Module):
        def __init__(self):
            super().__init__()
            self.w = nn.Parameter(torch.ones(3))

        @graphs.stage
        def forward(self, x):
            return {"y": Sampled.apply(x * self.w)}

    module, x = Launching().train(), torch.ones(3)
    before = (deform_attn.msda_fwd.launches, deform_attn.msda_bwd.launches)
    for _ in range(5):
        module(x)["y"].sum().backward()
    # 5 calls: eager, warm-up (the captures count none), three replays.
    assert (deform_attn.msda_fwd.launches - before[0],
            deform_attn.msda_bwd.launches - before[1]) == (10, 15)
    assert torch.equal(module.w.grad, torch.full((3,), 10.0))


def test_a_failed_train_capture_leaves_the_key_eager(config, cpu_graphs,
                                                     monkeypatch):
    emulated = graphs._captured

    def fail_backward(run, pool=graphs._SHARED):
        if pool is not None and pool is not graphs._SHARED:
            # a backward's capture, into its forward's pool
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return emulated(run, pool)

    monkeypatch.setattr(graphs, "_captured", fail_backward)
    eager, model = build(config), build(config)
    inputs = batch()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(3):
            for m in (eager, model):
                torch.manual_seed(1)
                with unwrapped() if m is eager else contextlib.nullcontext():
                    trained(m, inputs)
            same_grads(grads(model), grads(eager))
    assert len([w for w in caught if "no CUDA graph of the train step"
                in str(w.message)]) == STAGES
    assert captured(model) == 0


# -- the benchmark's reader ------------------------------------------------

def test_replay_share_reader(monkeypatch):
    sys.path.insert(0, BENCH)
    try:
        from harness import spec
        reader = spec.reader("dispatch.graph_replay_share.serve")
    finally:
        sys.path.remove(BENCH)
    for counted, want in (({}, None),
                          ({profiling.GRAPH_REPLAYS: 80}, 100.0),
                          ({profiling.GRAPH_REPLAYS: 30,
                            profiling.GRAPH_EAGER: 10}, 75.0),
                          ({profiling.GRAPH_EAGER: 8,
                            profiling.GRAPH_CAPTURES: 8}, 0.0)):
        monkeypatch.setattr(profiling, "counters", lambda c=counted: dict(c))
        assert reader.read(None) == want


def test_train_replay_share_reader(monkeypatch):
    """``dispatch.graph_replay_share.train`` is the serve reader over the
    train window: forward replays over stage calls; backward replays do
    not count."""
    sys.path.insert(0, BENCH)
    try:
        from harness import spec
        reader = spec.reader("dispatch.graph_replay_share.train")
    finally:
        sys.path.remove(BENCH)
    for counted, want in (({}, None),
                          ({profiling.GRAPH_REPLAYS: 20,
                            profiling.GRAPH_BACKWARD_REPLAYS: 20}, 100.0),
                          ({profiling.GRAPH_REPLAYS: 15,
                            profiling.GRAPH_EAGER: 5,
                            profiling.GRAPH_BACKWARD_REPLAYS: 15}, 75.0)):
        monkeypatch.setattr(profiling, "counters", lambda c=counted: dict(c))
        assert reader.read(None) == want
