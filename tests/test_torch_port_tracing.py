"""The program's spans and counters (``dpft_tpu_torch/utils/profiling.py``).

On the tiny model of the benchmark's CPU tests
(``h100_bench/tests/tiny_kradar.json``) and the fixture's raw K-Radar tree:

- with no profiler, a span enters no ``record_function`` and the totals and
  counters stay as they were;
- under ``torch.profiler``, one forward, one ``train_step``, one AdamW step
  of ``build_optimizer`` and one prepare call over two worker threads open
  the named ``dpft.*`` spans, nested as the modules nest (in the Chrome
  trace for the main thread's spans; in the totals for the workers', whose
  ranges the profiler does not see);
- a span's self time is its time less its children's; the totals cover one
  profiler session; ``trace`` writes ``spans.json`` and the unit ids;
- the host-sync counter reads 31 per train step on one rank: 17 in the
  matching, 13 in the metric, 1 at the gate;
- under ``computing.remat`` the recomputed backbones open their spans again;
- outputs, loss and gradients are bit-equal with spans on and off, and the
  ``torch.export`` program holds no profiler operator.
"""

import copy
import json
import os
import os.path as osp
import re
import sys
import threading

import numpy as np
import pytest
import torch

from dpft_tpu_torch.data import prepare as prepare_dataset
from dpft_tpu_torch.evaluation.evaluator import to_device
from dpft_tpu_torch.export import export_forward
from dpft_tpu_torch.models import dpft
from dpft_tpu_torch.models.layers.common import init_parameters
from dpft_tpu_torch.training.optimizer import build_optimizer
from dpft_tpu_torch.training.trainer import CentralizedTrainer
from dpft_tpu_torch.utils import profiling
from kradar_fixture import base_config, make_raw_kradar
from test_full_model_parity import make_batch

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG = osp.join(ROOT, "h100_bench", "tests", "tiny_kradar.json")
CPU = torch.device("cpu")
VIEWS, ITERATIONS = 3, 2


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def config():
    with open(CONFIG) as f:
        return json.load(f)


def build(config, remat=False):
    config = copy.deepcopy(config)
    config["computing"]["remat"] = remat
    model = dpft.from_config(config)
    return init_parameters(model, torch.Generator().manual_seed(0))


def inputs(B=2, M=8, seed=0):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(-np.pi, np.pi, (B, M))
    targets = {
        "gt_class": np.eye(2)[rng.integers(0, 2, (B, M))],
        "gt_center": np.stack([rng.uniform(1, 60, (B, M)),
                               rng.uniform(-6, 6, (B, M)),
                               rng.uniform(-1, 1, (B, M))], -1),
        "gt_size": rng.uniform(1, 4, (B, M, 3)),
        "gt_angle": np.stack([np.sin(ang), np.cos(ang)], -1),
    }
    targets = {k: v.astype(np.float32) for k, v in targets.items()}
    targets["gt_mask"] = np.arange(M)[None].repeat(B, 0) < np.array(
        [5, 3])[:, None]
    return to_device(make_batch(rng), CPU), to_device(targets, CPU)


def fresh_session(tmp_path):
    """Opens and closes an empty session: totals and counters empty."""
    with profiling.trace(str(tmp_path / "empty"), CPU):
        pass
    assert profiling.span_totals() == {} and profiling.counters() == {}


def recorded(fn):
    """Runs ``fn`` inside one profiler window; returns the trace's
    ``dpft.*`` ranges of the calling thread as (start, end, name)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = [e for e in prof.events() if e.name.startswith("dpft.")]
    main = {e.thread for e in events if e.name in (
        "dpft.forward", "dpft.train.step", "dpft.train.optimizer")}
    return sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.thread in main),
                  key=lambda s: (s[0], -s[1]))


def parents(ranges):
    """Each range's innermost enclosing ``dpft.*`` range (None at the
    top)."""
    out, stack = [], []
    for start, end, name in ranges:
        while stack and stack[-1][1] < end:
            stack.pop()
        out.append((name, stack[-1][2] if stack else None))
        stack.append((start, end, name))
    return out


def forward_parent(name):
    """The span that holds ``name`` inside one forward."""
    if name in ("dpft.frontend", "dpft.decoder"):
        return "dpft.forward"
    if name.startswith("dpft.frontend."):
        return "dpft.frontend"
    if name.startswith("dpft.decoder."):
        return "dpft.decoder"
    raise KeyError(name)


def forward_names():
    names = {"dpft.forward", "dpft.frontend", "dpft.decoder",
             "dpft.decoder.querent"}
    for v in range(VIEWS):
        names |= {f"dpft.frontend.view{v}.{part}"
                  for part in ("backbone", "neck", "embedding")}
    for i in range(ITERATIONS):
        prefix = f"dpft.decoder.fusion{i}"
        names |= {f"{prefix}.reference_points", f"{prefix}.head",
                  f"{prefix}.reduction"}
        for v in range(VIEWS):
            names |= {f"{prefix}.view{v}.{part}"
                      for part in ("self_attn", "msda", "ffn")}
    return names


def test_spans_off_enter_no_range_and_record_nothing(config, tmp_path,
                                                     monkeypatch):
    model = build(config).eval()
    batch, _ = inputs()
    fresh_session(tmp_path)
    entered = []
    inner = torch.profiler.record_function

    def counting(*args, **kwargs):
        entered.append(args[0])
        return inner(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert not profiling.enabled()
    with torch.inference_mode():
        model(batch)
    trainer = CentralizedTrainer.from_config(config)
    trainer.train_step(model, *inputs())
    assert entered == []
    assert profiling.span_totals() == {} and profiling.counters() == {}


def test_forward_spans_nest_as_the_modules(config):
    model = build(config).eval()
    batch, _ = inputs()

    def forward():
        with torch.inference_mode():
            model(batch)

    ranges = recorded(forward)
    assert {name for _, _, name in ranges} == forward_names()
    for name, parent in parents(ranges):
        if name == "dpft.forward":
            assert parent is None
        else:
            assert parent == forward_parent(name), name
    totals = profiling.span_totals()
    assert set(totals) == forward_names()
    assert all(t["calls"] == 1 for t in totals.values())
    view = [name for _, _, name in ranges if ".view1." in name
            and name.startswith("dpft.decoder.fusion0")]
    assert view == [f"dpft.decoder.fusion0.view1.{part}"
                    for part in ("self_attn", "msda", "ffn")]


def test_train_step_spans_and_the_host_syncs(config):
    model = build(config)
    trainer = CentralizedTrainer.from_config(config)
    batch, targets = inputs()
    # The first step fills the MSDA layers' caches of level sizes, one
    # copy to the device each.
    trainer.train_step(model, batch, targets)
    ranges = recorded(lambda: trainer.train_step(model, batch, targets))
    steps = [f"dpft.train.{p}" for p in ("forward", "match", "loss",
                                         "metric", "gate", "backward")]
    found = parents(ranges)
    assert [n for n, p in found if p == "dpft.train.step"] == steps
    assert ("dpft.forward", "dpft.train.forward") in found
    assert ("dpft.train.step", None) in found
    # 17 in the matching (13 pageable copies of the boxes' constant tables,
    # the cost and the mask read back, the two indices sent back), 13 in
    # the metric (the same tables), 1 at the gate.
    assert profiling.counters() == {"dpft.host_syncs": 31}
    totals = profiling.span_totals()
    assert totals["dpft.train.step"]["calls"] == 1
    assert totals["dpft.train.gate"]["host_s"] > 0


def test_optimizer_step_is_one_span(config):
    model = build(config)
    make = build_optimizer("AdamW", lr=1e-3)
    optimizer = make(model.parameters())
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    ranges = recorded(optimizer.step)
    assert [(n, p) for n, p in parents(ranges)] == [
        ("dpft.train.optimizer", None)]
    assert profiling.span_totals()["dpft.train.optimizer"]["calls"] == 1
    optimizer.step()  # no profiler: no span, the totals stay
    assert profiling.span_totals()["dpft.train.optimizer"]["calls"] == 1


def test_self_time_is_the_time_less_the_children(config):
    model = build(config).eval()
    batch, _ = inputs()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.inference_mode():
            model(batch)
            model(batch)
    totals = profiling.span_totals()
    children = {}
    for name in forward_names() - {"dpft.forward"}:
        parent = forward_parent(name)
        children[parent] = children.get(parent, 0.0) + totals[name]["host_s"]
    for name, t in totals.items():
        assert t["calls"] == 2
        assert t["self_s"] == pytest.approx(
            t["host_s"] - children.get(name, 0.0), abs=1e-8), name
        assert 0 <= t["self_s"] <= t["host_s"]


def test_totals_cover_one_profiler_session_and_trace_writes_them(
        config, tmp_path):
    model = build(config).eval()
    batch, _ = inputs()
    for forwards in (3, 1):
        # A forward with the profiler off, then a window: a new session.
        with torch.inference_mode():
            model(batch)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            with torch.inference_mode():
                for _ in range(forwards):
                    model(batch)
        assert profiling.span_totals()["dpft.forward"]["calls"] == forwards
    with torch.inference_mode():
        model(batch)  # no profiler: nothing added, the totals stay
    assert profiling.span_totals()["dpft.forward"]["calls"] == 1

    with profiling.trace(str(tmp_path), CPU):
        with torch.inference_mode():
            model(batch)
            model(batch)
    with open(tmp_path / profiling.SPANS_FILE) as f:
        written = json.load(f)
    assert written["spans"]["dpft.forward"]["calls"] == 2
    assert written["spans"] == profiling.span_totals()
    assert written["counters"] == {}
    with open(tmp_path / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    ids = [e["args"].get("id") for e in events
           if e.get("name") == "dpft.forward"]
    assert sorted(ids) == [0, 1]
    inner = [e for e in events if e.get("name") == "dpft.frontend"]
    assert len(inner) == 2 and all("id" not in e["args"] for e in inner)


def test_prepare_workers_reach_the_totals(tmp_path):
    src = make_raw_kradar(str(tmp_path / "raw"))
    config = base_config()
    assert config["computing"]["workers"] == 2
    processor = prepare_dataset(config["dataset"], config)
    processor.prepare(src, str(tmp_path / "untraced"))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        processor.prepare(src, str(tmp_path / "traced"))
    totals = profiling.span_totals()
    frames = len([d for _, dirs, _ in os.walk(tmp_path / "traced")
                  for d in dirs if re.fullmatch(r"\d{5}_\d{5}", d)])
    assert frames == 4
    parts = ["labels", "camera", "radar.read", "radar.to_device",
             "radar.reduce", "radar.to_host", "lidar", "write"]
    assert set(totals) == {"dpft.prepare.sample"} | {
        f"dpft.prepare.{p}" for p in parts}
    for name, t in totals.items():
        assert t["calls"] == frames, name
    children = sum(totals[f"dpft.prepare.{p}"]["host_s"] for p in parts)
    sample = totals["dpft.prepare.sample"]
    assert sample["self_s"] == pytest.approx(sample["host_s"] - children,
                                             abs=1e-8)
    # The cube's copy in and the planes' two copies back, per frame.
    assert profiling.counters() == {"dpft.host_syncs": 3 * frames}


def test_totals_lose_no_update_across_threads():
    threads, rounds = 16, 200
    profiling.enabled()  # found off: the next window opens a session
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            on = profiling.enabled()

            def work():
                with profiling.in_thread(on):
                    for _ in range(rounds):
                        with profiling.span("dpft.stress"):
                            with profiling.span("dpft.stress.inner"):
                                profiling.count("dpft.stress")

            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(before)
    totals = profiling.span_totals()
    assert totals["dpft.stress"]["calls"] == threads * rounds
    assert totals["dpft.stress.inner"]["calls"] == threads * rounds
    assert profiling.counters() == {"dpft.stress": threads * rounds}
    outer, inner = totals["dpft.stress"], totals["dpft.stress.inner"]
    assert outer["self_s"] == pytest.approx(
        outer["host_s"] - inner["host_s"], abs=1e-8)


def test_remat_reopens_the_backbone_spans_in_the_backward(config):
    model = build(config, remat=True)
    trainer = CentralizedTrainer.from_config(config)
    batch, targets = inputs()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        trainer.train_step(model, batch, targets)
    totals = profiling.span_totals()
    for v in range(VIEWS):
        assert totals[f"dpft.frontend.view{v}.backbone"]["calls"] == 2
        assert totals[f"dpft.frontend.view{v}.neck"]["calls"] == 1


def test_spans_change_no_number(config):
    model = build(config)
    twin = copy.deepcopy(model)
    trainer = CentralizedTrainer.from_config(config)
    batch, targets = inputs()

    def step(net):
        torch.manual_seed(3)  # the same dropout masks
        scalars = trainer.train_step(net, batch, targets)
        with torch.inference_mode():
            out = net.eval()(batch)
        return scalars, out, {k: p.grad for k, p in net.named_parameters()}

    off = step(model)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        on = step(twin)
    assert profiling.span_totals()["dpft.train.step"]["calls"] == 1
    assert on[0] == off[0]
    for k in off[1]:
        assert torch.equal(on[1][k], off[1][k]), k
    for k, g in off[2].items():
        assert (g is None) == (on[2][k] is None), k
        assert g is None or torch.equal(on[2][k], g), k


def test_exported_program_holds_no_profiler_op(config):
    model = build(config).eval()
    batch, _ = inputs(B=1)
    program = export_forward(model, batch)
    targets = [str(node.target) for node in program.graph.nodes
               if node.op == "call_function"]
    assert targets
    assert not [t for t in targets if "profiler" in t
                or "record_function" in t]
