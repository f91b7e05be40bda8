"""BatchNorm folded into the ResNet trunks' convolutions
(``dpft_tpu_torch/models/backbones/resnet.py``), on the CPU.

The served path folds only on the card; here the fold's arithmetic and its
freshness are driven through the backbone's own routines (``_Fold.refresh``
and ``_refresh_fold``, which its ``__call__`` runs first), and the folded
forward runs on the CPU
where a test adds the CPU to ``FOLD_DEVICES`` (its bias, residual and ReLU
then run as passes of their own, as without cuDNN).

- A folded pair (a 1x1 conv, a 3x3 stride-2 conv, a downsample) against
  ``bn(conv(x))`` with drawn running statistics: within 1e-12 of the
  largest element in float64, within a few float32 ulps of it in float32.
- The state_dict keys of ResNet-50 / 101 are the parent's; no folded
  tensor is a parameter or buffer.
- The folded tensors hold no autograd history and are no inference
  tensors, whether folded under ``no_grad`` or ``inference_mode``.
- A refold of exactly the changed pairs after an in-place weight update, a
  running statistic's ``copy_``, ``load_state_dict``,
  ``load_state_dict(assign=True)``, a ``train()`` / ``eval()`` round trip
  and a call in train mode (also one whose modes were set without
  ``train()``); none where nothing changed.
- The plain path on the CPU as it is (not counted: the counters count
  calls on a device that folds), and, with the CPU counted as one, in
  train mode, with grad on, under autocast, under ``FlopCounterMode``, with
  a BatchNorm in train mode, with a hook on a trunk module and for a
  float64 input; the folded forward otherwise, close to the plain one, and
  counted.
- The reader of ``frontend.bn_fold_share.serve``.
"""

import contextlib
import copy
import hashlib
import importlib.util
import os.path as osp
import pickle
import sys

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from dpft_tpu_torch.models.backbones import resnet
from dpft_tpu_torch.utils import profiling

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
BENCH = osp.join(ROOT, "h100_bench")


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def fold_on_cpu(monkeypatch):
    """The CPU counts as a device that folds."""
    monkeypatch.setattr(resnet, "FOLD_DEVICES", ("cuda", "cpu"))


def drawn(variant="resnet50", in_channels=3, multi_scale=2, seed=1):
    """A backbone in eval mode with drawn weights and running
    statistics."""
    torch.manual_seed(seed)
    model = resnet.ResNetBackbone(variant, in_channels, multi_scale)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5, generator=g)
                m.running_var.uniform_(0.2, 3.0, generator=g)
                m.weight.uniform_(0.3, 1.5, generator=g)
                m.bias.uniform_(-0.3, 0.3, generator=g)
    return model.eval()


def refolds(model, x):
    """The pairs folded again before a call on ``x``
    (``dpft.bn_fold.refolds`` in a profiler window), and whether the call
    may run folded."""
    with profiled(), torch.no_grad():
        resnet._refresh_fold(model, (x,))
    return profiling.counters().get(profiling.BN_FOLD_REFOLDS, 0), \
        model._fold.ready


@contextlib.contextmanager
def profiled():
    """A CPU profiler window with a session of its own, which starts at
    its beginning (a session ends when the main thread finds the profiler
    off, and starts when it finds it on)."""
    from torch.profiler import ProfilerActivity, profile

    profiling.enabled()
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.enabled()
        yield


def fold_counters():
    return {k: v for k, v in profiling.counters().items()
            if k.startswith("dpft.bn_fold.")}


def assert_fresh(model):
    """Every pair's folded tensors are those a new fold of the module's
    tensors gives."""
    for conv, bn in resnet.conv_bn_pairs(model.body):
        weight, bias = model._fold.tensors[conv]
        scale = bn.weight.double() / torch.sqrt(
            bn.running_var.double() + bn.eps)
        assert torch.equal(weight, (conv.weight.double() * scale.view(
            -1, 1, 1, 1)).to(weight.dtype))
        assert torch.equal(bias, (bn.bias.double() - bn.running_mean.double()
                                  * scale).to(bias.dtype))


# -- the arithmetic ---------------------------------------------------------

PAIRS = {
    "1x1": lambda b: (b.layer2[0].conv1, b.layer2[0].bn1, 256),
    "3x3_stride2": lambda b: (b.layer2[0].conv2, b.layer2[0].bn2, 128),
    "downsample": lambda b: (b.layer2[0].downsample[0],
                             b.layer2[0].downsample[1], 256),
}


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_a_folded_pair_is_bn_of_conv(pair, dtype):
    model = drawn().to(dtype)
    conv, bn, cin = PAIRS[pair](model.body)
    assert model._fold.refresh(model.body)
    weight, bias = model._fold.tensors[conv]
    assert weight.dtype == bias.dtype == dtype
    assert weight.is_contiguous(memory_format=torch.channels_last)
    x = torch.randn(2, cin, 20, 28, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = F.batch_norm(
            F.conv2d(x, conv.weight.double(), None, conv.stride,
                     conv.padding),
            bn.running_mean.double(), bn.running_var.double(),
            bn.weight.double(), bn.bias.double(), False, 0.0, bn.eps)
        got = F.conv2d(x.to(dtype), weight, bias, conv.stride, conv.padding)
    err = (got.double() - want).abs().max().item()
    scale = want.abs().max().item()
    if dtype == torch.float64:
        assert err <= 1e-12 * scale
    else:   # the 3x3 sums 1,152 products: about 9 ulps read
        assert err <= 16 * torch.finfo(torch.float32).eps * scale


# -- the keys ---------------------------------------------------------------

# The parent's state_dict keys (before the fold), by count and digest.
KEYS = {("resnet50", 6): (319, "4b5524f14ffac076"),
        ("resnet101", 3): (624, "6bcf256180c869bf")}


@pytest.mark.parametrize("variant,in_channels", sorted(KEYS))
def test_state_dict_keys_are_the_parents(variant, in_channels, fold_on_cpu):
    model = resnet.ResNetBackbone(variant, in_channels, 4).eval()
    tensors = {id(t) for t in (*model.parameters(), *model.buffers())}
    with torch.no_grad():
        model(torch.randn(1, in_channels, 32, 32))
    assert model._fold.ready
    assert len(model._fold.tensors) == model._n_pairs
    keys = list(model.state_dict())
    digest = hashlib.sha256("\n".join(keys).encode()).hexdigest()[:16]
    assert (len(keys), digest) == KEYS[variant, in_channels]
    assert {id(t) for t in (*model.parameters(), *model.buffers())} == \
        tensors
    folded = {id(t) for pair in model._fold.tensors.values() for t in pair}
    assert not folded & tensors


# -- freshness --------------------------------------------------------------

def _weight(model):
    with torch.no_grad():
        model.body.layer1[0].conv2.weight.mul_(1.5)
    return 1


def _statistics(model):
    with torch.no_grad():
        bn = model.body.layer2[1].bn3
        bn.running_var.copy_(bn.running_var * 2)
    return 1


def _load(model):
    model.load_state_dict({k: v * 1.01 if v.is_floating_point() else v
                           for k, v in model.state_dict().items()})
    return model._n_pairs


def _assign(model):
    model.load_state_dict({k: v * 1.01 if v.is_floating_point() else v
                           for k, v in model.state_dict().items()},
                          assign=True)
    return model._n_pairs


def _round_trip(model):
    model.train()
    model.eval()
    return model._n_pairs


def _train_call(model):
    model.train()
    with torch.no_grad():
        model(torch.randn(2, 3, 32, 32))   # batch statistics move
    model.eval()
    return model._n_pairs


def _train_flag(model):
    for m in model.modules():   # no train() call: the flag alone
        m.training = True
    with torch.no_grad():
        model(torch.randn(2, 3, 32, 32))
    for m in model.modules():
        m.training = False
    return model._n_pairs


def _nothing(model):
    return 0


CHANGES = {"in_place_weight": _weight, "running_statistics_copy": _statistics,
           "load_state_dict": _load, "load_state_dict_assign": _assign,
           "train_eval_round_trip": _round_trip, "train_call": _train_call,
           "train_flag_call": _train_flag, "nothing": _nothing}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_a_change_refolds_its_pairs(change, fold_on_cpu):
    model = drawn()
    x = torch.randn(1, 3, 32, 32)
    assert refolds(model, x) == (model._n_pairs, True)
    assert refolds(model, x) == (0, True)
    want = CHANGES[change](model)
    assert refolds(model, x) == (want, True)
    assert_fresh(model)
    assert refolds(model, x) == (0, True)


def test_a_rebound_tensor_refolds_its_pair(fold_on_cpu):
    model = drawn()
    x = torch.randn(1, 3, 32, 32)
    refolds(model, x)
    bn = model.body.layer1[1].bn2
    bn.weight.data = bn.weight.data * 2   # no version moves
    assert refolds(model, x) == (1, True)
    model.to(torch.float64).to(torch.float32)   # moved, values as they were
    assert refolds(model, x) == (model._n_pairs, True)
    assert_fresh(model)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_folded_tensors_hold_no_autograd_history(mode, fold_on_cpu):
    """The fold runs outside autograd: no folded tensor requires grad or
    keeps the float64 products alive through a graph, and none is an
    inference tensor (a later fold under ``no_grad`` writes into it)."""
    model = drawn()
    x = torch.randn(1, 3, 32, 32)
    with torch.no_grad() if mode == "no_grad" else torch.inference_mode():
        model(x)
    for weight, bias in model._fold.tensors.values():
        for t in (weight, bias):
            assert not t.requires_grad and t.grad_fn is None
            assert not t.is_inference()
    _load(model)
    other = "inference_mode" if mode == "no_grad" else "no_grad"
    with torch.no_grad() if other == "no_grad" else torch.inference_mode():
        model(x)
    assert_fresh(model)


def test_copies_fold_for_themselves(fold_on_cpu):
    model = drawn()
    x = torch.randn(1, 3, 32, 32)
    refolds(model, x)
    for twin in (copy.deepcopy(model), pickle.loads(pickle.dumps(model))):
        assert not twin._fold.tensors
        assert refolds(twin, x) == (twin._n_pairs, True)
        assert_fresh(twin)
        assert all(twin._fold.tensors[c][0].data_ptr()
                   != model._fold.tensors[m][0].data_ptr()
                   for (c, _), (m, _) in zip(
                       resnet.conv_bn_pairs(twin.body),
                       resnet.conv_bn_pairs(model.body)))


def test_a_refold_writes_in_place(fold_on_cpu):
    model = drawn()
    x = torch.randn(1, 3, 32, 32)
    refolds(model, x)
    held = {c: (w.data_ptr(), b.data_ptr())
            for c, (w, b) in model._fold.tensors.items()}
    _load(model)
    refolds(model, x)
    assert {c: (w.data_ptr(), b.data_ptr())
            for c, (w, b) in model._fold.tensors.items()} == held


# -- where the trunk folds --------------------------------------------------

def _train(model, x):
    model.train()
    return model(x)


def _grad(model, x):
    with torch.enable_grad():
        return model(x)


def _autocast(model, x):
    with torch.autocast("cpu", dtype=torch.bfloat16):
        return model(x)


def _flop_counter(model, x):
    with FlopCounterMode(display=False):
        return model(x)


def _bn_in_train_mode(model, x):
    model.body.layer1[0].bn1.train()
    return model(x)


def _hooked(model, x):
    model.body.layer1[0].conv1.register_forward_hook(lambda *a: None)
    return model(x)


def _float64(model, x):
    return model.double()(x.double())


PLAIN = {"train_mode": _train, "grad_enabled": _grad, "autocast": _autocast,
         "flop_counter_mode": _flop_counter,
         "batchnorm_in_train_mode": _bn_in_train_mode,
         "hook_on_a_trunk_module": _hooked, "float64_input": _float64}


@pytest.mark.parametrize("case", sorted(PLAIN))
def test_the_plain_path_runs_where_a_condition_fails(case, fold_on_cpu):
    model = drawn()
    x = torch.randn(1, 3, 32, 32)
    with profiled(), torch.no_grad():
        PLAIN[case](model, x)
    assert fold_counters() == {profiling.BN_FOLD_PLAIN: model._n_pairs}
    assert not model._fold.ready


def test_the_cpu_runs_the_plain_path_and_counts_nothing():
    assert resnet.FOLD_DEVICES == ("cuda",)
    model = drawn()
    x = torch.randn(1, 3, 32, 32)
    with profiled(), torch.inference_mode():
        got = model(x)
    assert fold_counters() == {}
    assert not model._fold.tensors and not model._fold.ready
    with torch.inference_mode():
        want = model.body(x)
    for k in want:
        assert torch.equal(got[k], want[k])


@pytest.mark.parametrize("variant,in_channels",
                         [("resnet50", 6), ("resnet18", 3)])
def test_the_folded_forward_is_the_plain_one(variant, in_channels,
                                             fold_on_cpu):
    model = drawn(variant, in_channels, multi_scale=4)
    x = torch.randn(1, 40, 56, in_channels).permute(0, 3, 1, 2)
    with torch.inference_mode():
        with profiled():
            got = model(x)
        counted = fold_counters()
        with FlopCounterMode(display=False):   # the plain path
            want = model(x)
    assert counted == {profiling.BN_FOLD_FOLDED: model._n_pairs,
                       profiling.BN_FOLD_REFOLDS: model._n_pairs}
    assert got.keys() == want.keys()
    for k in want:
        scale = want[k].abs().max().item()
        assert (got[k] - want[k]).abs().max().item() <= 1e-5 * scale, k


# -- the per-layer reader ---------------------------------------------------

def _reader():
    path = osp.join(BENCH, "metrics", "frontend.bn_fold_share.serve.py")
    spec = importlib.util.spec_from_file_location("bn_fold_share", path)
    module = importlib.util.module_from_spec(spec)
    sys.path.insert(0, BENCH)
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(BENCH)
    return module


@pytest.mark.parametrize("folded,plain,want", [
    (0, 0, None), (53, 0, 100.0), (0, 53, 0.0), (104, 106, 104 / 210 * 100)])
def test_the_share_reader(folded, plain, want):
    read = _reader().read
    with profiled():
        for name, n in ((profiling.BN_FOLD_FOLDED, folded),
                        (profiling.BN_FOLD_PLAIN, plain)):
            if n:
                profiling.count(name, n)
    got = read(None)
    assert got == pytest.approx(want) if want is not None else got is None
