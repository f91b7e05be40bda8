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
- The per-layer reader ``dispatch.graph_replay_share.serve`` reads the
  counters.
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
from dpft_tpu_torch.ops import deform_attn
from dpft_tpu_torch.utils import profiling
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
    call again on the graph's own inputs and writes its result into the
    graph's own outputs."""

    def __init__(self, run, result):
        self.run, self.outputs = run, []
        graphs._flatten(result, self.outputs)

    def replay(self):
        counted = [w.launches for w in graphs._COUNTED]
        fresh = []
        with profiling.tally():   # no Python ran: the graph's own counts
            graphs._flatten(self.run(), fresh)
        for out, new in zip(self.outputs, fresh):
            out.copy_(new)
        for wrapper, n in zip(graphs._COUNTED, counted):  # no Python ran
            wrapper.launches = n


@pytest.fixture
def cpu_graphs(monkeypatch):
    """Lets the CPU graph, with the capture emulated; counts captures."""
    made = []

    def captured_run(run):
        result = run()
        made.append(_Emulated(run, result))
        return made[-1], result

    def capture(forward, module, args, kwargs, spec, tensors):
        out = forward(module, *args, **kwargs)
        return out, graphs._record(forward, module, spec, tensors)

    monkeypatch.setattr(graphs, "GRAPH_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(graphs, "_captured", captured_run)
    monkeypatch.setattr(graphs, "_capture", capture)
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
    """The graphs share one memory pool: every capture names it."""
    pools = []

    class Graph:
        def capture_begin(self, pool=None, capture_error_mode=None):
            pools.append(pool)

        def capture_end(self):
            pass

    handles = iter(range(10))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: (next(handles), 0))
    monkeypatch.setattr(graphs, "_pool", None)
    for n in range(3):
        graph, result = graphs._captured(lambda: n)
        assert isinstance(graph, Graph) and result == n
    assert pools == [(0, 0)] * 3


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
