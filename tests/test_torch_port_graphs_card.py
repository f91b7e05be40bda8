"""CUDA graphs of the train step (``dpft_tpu_torch/models/graphs.py``) on
the card; every test here skips without one.

- The flagship (``config/kradar.json``) at B=4, float32, TF32 off, with
  ``torch.backends.cudnn.deterministic``: two models from the same
  weights, one with every stage eager and one whose stages replay a
  forward and a backward graph from the third step on, take five steps of
  ``CentralizedTrainer.train_step`` and AdamW from the same generator
  state. They agree bit for bit in the losses, every ``.grad`` after each
  step, every parameter, BatchNorm's running statistics and
  ``num_batches_tracked``, and ``torch.cuda.get_rng_state()``. An eval
  forward afterwards replays its own graphs and equals the eager one.
- Remat (the backbones under ``torch.utils.checkpoint`` stay eager, the
  other stages replay), the matmul-form MSDA (``fuser.pallas_msda:
  "mm"``) and a Swin-B camera trunk in train mode: each replays, bit-equal
  to eager, without a failed capture.
- A stage whose forward makes the host wait for the card is not captured;
  one whose backward does fails its capture before the driver sees the
  sync. Both run eagerly, and later captures of the process still work.
- BatchNorm folded into the ResNet trunks' convolutions
  (``models/backbones/resnet.py``), on the flagship at B=1 in eval with
  drawn running statistics: the folded forward, eager and replayed, within
  1e-5 of each output's largest element of the plain path (the same model
  under a mode that changes no operation, ``_Plain``), replay bit-equal to
  eager, every pair counted folded and none folded again in a steady
  call; the same after train steps whose replays moved BatchNorm's
  statistics without moving their versions, and after a
  ``load_state_dict`` between two replays in eval.

Run with ``python -m pytest tests/test_torch_port_graphs_card.py -m card``
on a machine with a card.
"""

import contextlib
import copy
import json
import os.path as osp
import warnings

import pytest
import torch
import torch.nn as nn

from dpft_tpu_torch.evaluation.evaluator import to_device
from dpft_tpu_torch.models import graphs, registry
from dpft_tpu_torch.training.trainer import CentralizedTrainer
from dpft_tpu_torch.utils.example import example_batch, example_targets

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
STAGES = 3 * 3 + 1      # per view backbone, neck, embedding; the fuser


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda", 0)
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = saved


def config(name="kradar", **fuser):
    with open(osp.join(ROOT, "config", f"{name}.json")) as f:
        out = json.load(f)
    out["model"]["fuser"].update(fuser)
    return out


@contextlib.contextmanager
def eager_stages():
    """Every stage eager: no device graphs."""
    saved = graphs.GRAPH_DEVICES
    graphs.GRAPH_DEVICES = ()
    try:
        yield
    finally:
        graphs.GRAPH_DEVICES = saved


def train_graphs(model):
    return sum(isinstance(g, graphs._TrainGraph)
               for m in model.modules() if "_graphs" in m.__dict__
               for g in m.__dict__["_graphs"].graphs.values())


def equal(what, got, want):
    assert got.keys() == want.keys(), what
    for k in want:
        a, b = got[k], want[k]
        assert (a is None) == (b is None), f"{what}: {k}"
        if a is not None:
            assert torch.equal(a, b), f"{what}: {k} differs by " \
                f"{(a.double() - b.double()).abs().max().item():.3e}"


class _Plain(torch.overrides.TorchFunctionMode):
    """A mode that changes no operation. Under it every stage runs eagerly
    and the ResNet trunks run their BatchNorms unfolded."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


FOLDED_PAIRS = 104 + 2 * 53   # the flagship's ResNet-101 and ResNet-50s


def near(what, got, want, tol=1e-5):
    """Every output within ``tol`` of its largest element of ``want``."""
    assert got.keys() == want.keys(), what
    for k in want:
        scale = want[k].abs().max().item()
        err = (got[k] - want[k]).abs().max().item()
        assert err <= tol * scale, f"{what}: {k} differs by {err:.3e} " \
            f"of {scale:.3e}"


def drawn_statistics(model, seed=3):
    """BatchNorm weights, biases and running statistics drawn away from
    their initial values, so that a fold does real work."""
    g = torch.Generator(device=next(model.parameters()).device)
    g.manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.1, 0.1, generator=g)
    return model


def fold_counts(run):
    """``run()`` in a profiler window; its result and the counts of
    ``dpft.bn_fold.*``."""
    from torch.profiler import ProfilerActivity, profile
    from dpft_tpu_torch.utils import profiling

    with profile(activities=[ProfilerActivity.CPU]):
        out = run()
    return out, {k: v for k, v in profiling.counters().items()
                 if k.startswith("dpft.bn_fold.")}


def grads(model):
    return {k: None if p.grad is None else p.grad.clone()
            for k, p in model.named_parameters()}


def steps_against_eager(cfg, card, steps, B, cam_hw=(512, 910),
                        remat=False):
    """``steps`` train steps of two models from the same weights, one with
    every stage eager, from the same generator state each step; holds
    every reading bit-equal; returns the replaying model, its eager twin
    and the last batch."""
    if remat:
        cfg = copy.deepcopy(cfg)
        cfg["computing"]["remat"] = True
    trainer = CentralizedTrainer.from_config(cfg)
    eager, graphed = (registry.build(cfg["model"]["name"], cfg,
                                     device=card, seed=0)
                      for _ in range(2))
    optimizers = [trainer.optimizer_factory(m.parameters())
                  for m in (eager, graphed)]
    torch.manual_seed(7)
    for step in range(steps):
        batch = to_device(example_batch(cfg, B=B, cam_hw=cam_hw,
                                        seed=step % 2), card)
        targets = to_device(example_targets(cfg, B=B, seed=step), card)
        state = torch.cuda.get_rng_state()
        readings = []
        for model, optimizer in zip((eager, graphed), optimizers):
            torch.cuda.set_rng_state(state)
            with eager_stages() if model is eager else \
                    contextlib.nullcontext():
                scalars = trainer.train_step(model, batch, targets)
            readings.append((scalars, grads(model),
                             torch.cuda.get_rng_state()))
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
        (want, want_grads, want_rng), (got, got_grads, got_rng) = readings
        assert got == want, (step, got, want)
        equal(f"step {step} gradients", got_grads, want_grads)
        assert torch.equal(got_rng, want_rng), step
        equal(f"step {step} parameters", dict(graphed.named_parameters()),
              dict(eager.named_parameters()))
        equal(f"step {step} buffers", dict(graphed.named_buffers()),
              dict(eager.named_buffers()))
    return eager, graphed, batch


@pytest.mark.card
def test_flagship_train_replays_are_bit_equal_to_eager(card):
    from torch.profiler import ProfilerActivity, profile
    from dpft_tpu_torch.utils import profiling

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eager, graphed, batch = steps_against_eager(config(), card, 5, 4)
    failed = [str(w.message) for w in caught
              if "no CUDA graph" in str(w.message)]
    assert not failed, failed
    assert train_graphs(graphed) == STAGES
    trainer = CentralizedTrainer.from_config(config())
    targets = to_device(example_targets(config(), B=4, seed=9), card)
    state = torch.cuda.get_rng_state()
    with eager_stages():
        trainer.train_step(eager, batch, targets)   # the same statistics
    torch.cuda.set_rng_state(state)
    with profile(activities=[ProfilerActivity.CPU]):
        trainer.train_step(graphed, batch, targets)
    counted = profiling.counters()
    assert counted.get(profiling.GRAPH_REPLAYS) == STAGES, counted
    assert counted.get(profiling.GRAPH_BACKWARD_REPLAYS) == STAGES, counted
    assert profiling.GRAPH_EAGER not in counted, counted
    graphed.zero_grad(set_to_none=True)
    eager.zero_grad(set_to_none=True)
    with torch.inference_mode():
        with eager_stages():
            want = eager.eval()(batch)
        for _ in range(3):
            got = graphed.eval()(batch)
    equal("eval forward after training", got, want)
    assert sum(isinstance(g, graphs._Graph)
               and not isinstance(g, graphs._TrainGraph)
               for m in graphed.modules() if "_graphs" in m.__dict__
               for g in m.__dict__["_graphs"].graphs.values()) == STAGES


@pytest.mark.card
@pytest.mark.parametrize("case", ["remat", "mm", "swin"])
def test_remat_mm_and_swin_train_steps(card, case):
    cfg = {"remat": config(), "mm": config(pallas_msda="mm"),
           "swin": config("kradar_swinb")}[case]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, graphed, _ = steps_against_eager(cfg, card, 4, 2,
                                            remat=case == "remat")
    failed = [str(w.message) for w in caught
              if "no CUDA graph" in str(w.message)]
    assert not failed, failed
    # Under remat the backbones run inside a checkpoint: eager.
    assert train_graphs(graphed) == STAGES - 3 * (case == "remat")


class _Synced(nn.Module):
    """A stage whose forward or backward makes the host wait for the
    card."""

    def __init__(self, where):
        super().__init__()
        self.where = where
        self.w = nn.Parameter(torch.ones(8))

    @graphs.stage
    def forward(self, x):
        if self.where == "forward":
            x = x * (self.w.detach().sum().item() / 8)
        return {"y": _SyncedBackward.apply(x * self.w, self.where)}


class _SyncedBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, where):
        ctx.where = where
        return x * 2

    @staticmethod
    def backward(ctx, g):
        if ctx.where == "backward":
            g = g * (g.sum().item() * 0 + 1)
        return g * 2, None


@pytest.mark.card
@pytest.mark.parametrize("where", ["forward", "backward"])
def test_a_stage_that_syncs_runs_eagerly(card, where):
    module = _Synced(where).to(card).train()
    x = torch.randn(8, device=card)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(4):
            module(x)["y"].sum().backward()
    assert len([w for w in caught if "no CUDA graph" in str(w.message)]) == 1
    assert torch.equal(module.w.grad, 4 * 2 * x)
    assert train_graphs(module) == 0
    # The process still captures, and the generator still draws.
    other = _Synced("nowhere").to(card).train()
    for _ in range(3):
        other(x)["y"].sum().backward()
    assert train_graphs(other) == 1
    assert torch.equal(other.w.grad, 3 * 2 * x)
    torch.rand(4, device=card)


def served(cfg, card):
    return to_device(example_batch(cfg, B=1, cam_hw=(512, 910), seed=0),
                     card)


@pytest.mark.card
def test_the_flagship_b1_folded_forward_against_the_plain_path(card):
    cfg = config()
    model = drawn_statistics(registry.build(cfg["model"]["name"], cfg,
                                            device=card, seed=0)).eval()
    batch = served(cfg, card)
    with torch.inference_mode():
        with eager_stages():
            eager = model(batch)
        for _ in range(3):
            replayed = model(batch)
        again, counted = fold_counts(lambda: model(batch))
        with _Plain():
            plain = model(batch)
    equal("replayed against eager, both folded", replayed, eager)
    equal("a later replay", again, eager)
    near("folded against plain", eager, plain)
    assert counted == {"dpft.bn_fold.folded": FOLDED_PAIRS}, counted


@pytest.mark.card
def test_the_fold_after_replayed_train_steps(card):
    """Steps 1-2 run eagerly (step 2 captures); the trunks fold in an eval
    forward after them; steps 3-5 replay, moving BatchNorm's statistics
    inside the graphs without moving their versions (no optimizer step:
    the weights stay). The next eval forward must fold them again."""
    cfg = config()
    trainer = CentralizedTrainer.from_config(cfg)
    model = drawn_statistics(registry.build(cfg["model"]["name"], cfg,
                                            device=card, seed=0))
    batch = served(cfg, card)
    stats = []
    for step in range(5):
        if step == 2:
            with torch.inference_mode():
                model.eval()(batch)
            stats.append([b.clone() for b in model.buffers()])
        train = to_device(example_batch(cfg, B=4, cam_hw=(512, 910),
                                        seed=step % 2), card)
        targets = to_device(example_targets(cfg, B=4, seed=step), card)
        trainer.train_step(model, train, targets)
        model.zero_grad(set_to_none=True)
    assert train_graphs(model) == STAGES
    assert any(not torch.equal(a, b)
               for a, b in zip(stats[0], model.buffers()))
    model.eval()
    with torch.inference_mode():
        got, counted = fold_counts(lambda: model(batch))
        for _ in range(2):
            replayed = model(batch)
        with _Plain():
            plain = model(batch)
    near("folded after replayed steps against plain", got, plain)
    equal("replayed after the steps", replayed, got)
    assert counted == {"dpft.bn_fold.folded": FOLDED_PAIRS,
                       "dpft.bn_fold.refolds": FOLDED_PAIRS}, counted


@pytest.mark.card
def test_load_state_dict_between_two_replays(card):
    cfg = config()
    model = drawn_statistics(registry.build(cfg["model"]["name"], cfg,
                                            device=card, seed=0)).eval()
    batch = served(cfg, card)
    with torch.inference_mode():
        for _ in range(3):
            before = model(batch)
    model.load_state_dict({k: v * 1.01 if v.is_floating_point() else v
                           for k, v in model.state_dict().items()})
    with torch.inference_mode():
        got, counted = fold_counts(lambda: model(batch))
        with eager_stages():
            eager = model(batch)
        with _Plain():
            plain = model(batch)
    assert counted == {"dpft.bn_fold.folded": FOLDED_PAIRS,
                       "dpft.bn_fold.refolds": FOLDED_PAIRS}, counted
    equal("the replay after load_state_dict", got, eager)
    near("the replay after load_state_dict against plain", got, plain)
    assert any(not torch.equal(got[k], before[k]) for k in got)
