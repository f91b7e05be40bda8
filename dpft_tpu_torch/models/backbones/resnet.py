"""ResNet backbones (18/34/50/101/152) returning intermediate stages.

Counterpart of dpft_tpu/models/backbones/resnet.py, in the reference's key
space: an optional bias-free 1x1 ``adjustment_layer`` that maps non-RGB
inputs (the 6-channel radar planes) to 3 channels, and a ``body`` with
torchvision's module names (conv1, bn1, layer{L}.{B}.conv{i} / bn{i} /
downsample.{0,1}), so torchvision state_dicts load into ``body`` as they
are. Only the stages up to ``multi_scale`` are built. Inputs are NCHW
tensors (channels_last memory suits cuDNN); the output is
{'1': layer1, ..., '<multi_scale>': ...}. BatchNorm uses its running
statistics in ``eval()``.

BatchNorm folded into the convolutions. Where all of these hold, which is
where a stage may replay an eval graph (``models/graphs.py``), each
conv -> BatchNorm pair of the trunk (``body.conv1`` / ``bn1``, each
block's ``conv{i}`` / ``bn{i}`` and ``downsample.{0,1}``) runs as one
convolution with a bias, and no BatchNorm runs:

- the backbone and every BatchNorm of the trunk are in eval mode and grad
  is disabled;
- the input is a float32 tensor on a device of ``FOLD_DEVICES`` (CUDA)
  and autocast is off there;
- no ``TorchFunctionMode`` or ``TorchDispatchMode`` is active, no global
  module hook is set, nothing exports, compiles or traces, and no module
  of the trunk carries a hook of its own;
- the pairs' tensors are plain tensors that track their versions (no
  inference tensor, no FSDP module).

Everywhere else (the CPU, train mode, autocast, ``torch.export``, the FLOP
count) the convolutions and BatchNorms run as written below. With
``s = gamma / sqrt(var + eps)`` the folded weight is ``w * s`` and the
bias ``beta - mean * s``, computed in float64 on the device and rounded
once to the weight's dtype. On the card a pair that ReLU follows is one
cuDNN call that adds the bias, and the block's residual where one is
added, in the convolution's epilogue and applies ReLU there
(``torch.cudnn_convolution_relu`` / ``_add_relu``); a downsample pair is
a convolution with a bias. The folded tensors are kept beside the module,
not among its parameters or buffers, so ``state_dict``, checkpoints and an
exported program hold what they held; the weights are in channels_last
memory, which cuDNN convolves without a copy of the weight per call.

The backbone's ``__call__``, before its hooks and the stage's eager call
or replay and outside any graph, folds again, in place (the graphs
read the folded tensors where they were captured), every pair whose
tensors changed since its last fold: a version moved (an in-place update:
an optimizer step, ``load_state_dict``) or a tensor was rebound or moved
(``.to()``, ``load_state_dict(assign=True)``). It folds every pair again
after a ``train(mode)`` switch of the backbone and after a call with the
backbone or a BatchNorm in train mode: a train graph's replay updates
BatchNorm's running statistics without moving their versions
(``models/graphs.py``). A call that changes nothing folds nothing. The
counters ``dpft.bn_fold.folded`` / ``.plain`` count the pairs that a call
on a device of ``FOLD_DEVICES`` runs folded / as convolution and
BatchNorm (a replayed stage counts as its capture did),
``dpft.bn_fold.refolds`` the pairs folded again (``utils/profiling.py``).
"""

from __future__ import annotations

import operator
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dpft_tpu_torch.models import graphs
from dpft_tpu_torch.models.graphs import stage
from dpft_tpu_torch.utils import profiling

_STAGES: Dict[str, tuple] = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}

FOLD_DEVICES = ("cuda",)   # where the trunk may run BatchNorm folded

_version = operator.attrgetter("_version")
_training = operator.attrgetter("training")


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                         nn.BatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, width, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.downsample = (_downsample(cin, width, stride)
                           if stride != 1 or cin != width else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)

    def folded(self, x: torch.Tensor, conv) -> torch.Tensor:
        """``forward`` with each pair through ``conv`` (``_Fold.conv``)."""
        out = conv(self.conv1, x, relu=True)
        identity = x if self.downsample is None else \
            conv(self.downsample[0], x)
        return conv(self.conv2, out, add=identity, relu=True)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, width * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(width * 4)
        self.downsample = (_downsample(cin, width * 4, stride)
                           if stride != 1 or cin != width * 4 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)

    def folded(self, x: torch.Tensor, conv) -> torch.Tensor:
        """``forward`` with each pair through ``conv`` (``_Fold.conv``)."""
        out = conv(self.conv1, x, relu=True)
        out = conv(self.conv2, out, relu=True)
        identity = x if self.downsample is None else \
            conv(self.downsample[0], x)
        return conv(self.conv3, out, add=identity, relu=True)


class ResNetBody(nn.Module):
    """torchvision-named ResNet trunk without the classifier."""

    def __init__(self, variant: str, multi_scale: int):
        super().__init__()
        kind, counts = _STAGES[variant]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.n_stages = min(multi_scale, 4)
        cin = 64
        for stage in range(self.n_stages):
            width = 64 * 2 ** stage
            blocks = []
            for b in range(counts[stage]):
                stride = 2 if stage > 0 and b == 0 else 1
                blocks.append(block(cin, width, stride))
                cin = width * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        outputs = {}
        for stage in range(1, self.n_stages + 1):
            x = getattr(self, f"layer{stage}")(x)
            outputs[str(stage)] = x
        return outputs

    def folded(self, x: torch.Tensor, conv) -> Dict[str, torch.Tensor]:
        """``forward`` with each pair through ``conv`` (``_Fold.conv``)."""
        x = F.max_pool2d(conv(self.conv1, x, relu=True), 3, 2, 1)
        outputs = {}
        for stage in range(1, self.n_stages + 1):
            for block in getattr(self, f"layer{stage}"):
                x = block.folded(x, conv)
            outputs[str(stage)] = x
        return outputs


def conv_bn_pairs(body: ResNetBody) -> List[Tuple[nn.Conv2d, nn.Module]]:
    """Every conv -> BatchNorm pair of the trunk, in the order it runs."""
    pairs = [(body.conv1, body.bn1)]
    for stage in range(1, body.n_stages + 1):
        for block in getattr(body, f"layer{stage}"):
            pairs += [(getattr(block, f"conv{i}"), getattr(block, f"bn{i}"))
                      for i in (1, 2, 3) if hasattr(block, f"conv{i}")]
            if block.downsample is not None:
                pairs.append((block.downsample[0], block.downsample[1]))
    return pairs


def _foldable(module: nn.Module, x: torch.Tensor) -> bool:
    """Whether the call of ``module`` on ``x`` meets the conditions of the
    module docstring that the call itself decides."""
    kind = x.device.type
    return (kind in FOLD_DEVICES and x.dtype == torch.float32
            and not (module.training or torch.is_grad_enabled()
                     or torch.is_autocast_enabled(kind)
                     or graphs._modes_or_tracing()))


class _Fold:
    """A trunk's folded tensors and what they were folded from, kept on
    the backbone as ``_fold``. A copy of the backbone (``copy.deepcopy``,
    pickle) starts with none. ``ready``: the last call found itself
    foldable and left every pair folded."""

    __slots__ = ("epoch", "ok", "pairs", "bns", "hooks", "tables", "names",
                 "key", "tensors", "ready")

    def __init__(self):
        self.epoch = -1
        self.ok = False
        self.pairs: List[Tuple[nn.Conv2d, nn.Module]] = []
        self.bns: List[nn.Module] = []
        self.hooks: List[dict] = []
        self.tables: List[dict] = []   # where each pair's 5 tensors are
        self.names: List[str] = []     # registered
        self.key: Optional[tuple] = None         # versions, addresses
        self.tensors: Dict[nn.Conv2d, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.ready = False

    def __deepcopy__(self, memo) -> "_Fold":
        return _Fold()

    def __reduce__(self):
        return _Fold, ()

    def _walk(self, body: ResNetBody) -> None:
        """Reads the trunk's pairs, hooks and tensors, and whether they may
        be folded at all."""
        fsdp = ()
        if torch.distributed.is_available():
            from torch.distributed.fsdp import FSDPModule as fsdp
        self.epoch = graphs._epoch
        self.key = None
        self.pairs = conv_bn_pairs(body)
        self.bns = [bn for _, bn in self.pairs]
        modules = list(body.modules())
        self.hooks = [h for m in modules
                      for h in (m._forward_hooks, m._forward_pre_hooks)]
        places = [place for conv, bn in self.pairs for place in (
            (conv._parameters, "weight"), (bn._parameters, "weight"),
            (bn._parameters, "bias"), (bn._buffers, "running_mean"),
            (bn._buffers, "running_var"))]
        self.tables = [table for table, _ in places]
        self.names = [name for _, name in places]
        sources = [table.get(name) for table, name in places]
        self.ok = (not any(isinstance(m, fsdp) for m in modules)
                   and all(conv.bias is None for conv, _ in self.pairs)
                   and all(type(t) in graphs._PLAIN and not t.is_inference()
                           for t in sources))
        convs = {conv for conv, _ in self.pairs}
        self.tensors = {c: t for c, t in self.tensors.items() if c in convs}

    def refresh(self, body: ResNetBody) -> bool:
        """Folds again every pair whose tensors changed since its last fold
        (all of them after ``stale``). Returns whether the trunk may run
        folded: False where a condition on the trunk's modules and tensors
        fails (a BatchNorm in train mode also makes every pair stale)."""
        if self.epoch != graphs._epoch:
            self._walk(body)
        if not self.ok or any(self.hooks):
            return False
        if any(map(_training, self.bns)):
            self.key = None
            return False
        try:   # maps, not comprehensions: this runs before every call
            sources = list(map(dict.__getitem__, self.tables, self.names))
            key = (list(map(_version, sources)),
                   list(map(torch.Tensor.data_ptr, sources)))
        except (KeyError, TypeError, AttributeError, RuntimeError):
            self.epoch = -1   # read the trunk again
            return False
        if key != self.key:
            if self.key is None:
                changed = range(len(self.pairs))
            else:
                changed = sorted({i // 5 for new, old in zip(key, self.key)
                                  for i, (a, b) in enumerate(zip(new, old))
                                  if a != b})
            self.fold(changed)
            self.key = key
        return True

    def stale(self) -> None:
        """Every pair is folded again at the next foldable call."""
        self.key = None

    def fold(self, indexes: Sequence[int]) -> None:
        """Folds the pairs at ``indexes`` into their tensors, in place
        where those exist on the weight's device, dtype and shape."""
        with torch.inference_mode(False), torch.no_grad():
            for i in indexes:
                conv, bn = self.pairs[i]
                w = conv.weight
                held = self.tensors.get(conv)
                if held is None or (held[0].device, held[0].dtype,
                                    held[0].shape) != (w.device, w.dtype,
                                                       w.shape):
                    held = self.tensors[conv] = (
                        torch.empty_like(w, memory_format=torch.channels_last),
                        w.new_empty(w.shape[0]))
                scale = bn.weight.double() / torch.sqrt(
                    bn.running_var.double() + bn.eps)
                held[0].copy_(w.double() * scale.view(-1, 1, 1, 1))
                held[1].copy_(bn.bias.double() - bn.running_mean.double()
                              * scale)
        profiling.count(profiling.BN_FOLD_REFOLDS, len(indexes))

    def conv(self, conv: nn.Conv2d, x: torch.Tensor, relu: bool = False,
             add: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The pair of ``conv`` on ``x`` folded: ``conv(x) + bias``, plus
        ``add`` where given, through ReLU where ``relu``. Where cuDNN takes
        ``x``, a pair followed by ReLU is one cuDNN call that adds the bias
        (and ``add``) and applies ReLU in the convolution's epilogue;
        otherwise bias, ``add`` and ReLU are passes of their own."""
        weight, bias = self.tensors[conv]
        args = (conv.stride, conv.padding, conv.dilation, conv.groups)
        if relu and torch.backends.cudnn.is_acceptable(x):
            if add is None:
                return torch.cudnn_convolution_relu(x, weight, bias, *args)
            return torch.cudnn_convolution_add_relu(x, weight, add, 1.0,
                                                    bias, *args)
        y = F.conv2d(x, weight, bias, *args)
        if add is not None:
            y = y.add_(add)
        return y.relu_() if relu else y


def _refresh_fold(module: "ResNetBackbone", args: tuple) -> None:
    """Run by the backbone's ``__call__`` first: where this call runs
    folded, makes every pair's folded tensors current, outside any
    graph."""
    fold = module._fold
    fold.ready = False
    if module.training:
        fold.stale()
    elif args and isinstance(args[0], torch.Tensor) and \
            _foldable(module, args[0]):
        fold.ready = fold.refresh(module.body)


class ResNetBackbone(nn.Module):
    def __init__(self, variant: str = "resnet50", in_channels: int = 3,
                 multi_scale: int = 4):
        super().__init__()
        if variant not in _STAGES:
            raise ValueError(f"Unknown ResNet variant: {variant}")
        self.adjustment_layer = (nn.Conv2d(in_channels, 3, 1, bias=False)
                                 if in_channels != 3 else None)
        self.body = ResNetBody(variant, multi_scale)
        self._fold = _Fold()
        self._n_pairs = len(conv_bn_pairs(self.body))

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        _refresh_fold(self, args)   # before the hooks and the stage's graph
        return super().__call__(*args, **kwargs)

    def train(self, mode: bool = True) -> "ResNetBackbone":
        if mode != self.training:
            self._fold.stale()
        return super().train(mode)

    @stage
    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        fold = self._fold.ready and _foldable(self, x)
        if self.adjustment_layer is not None:
            x = self.adjustment_layer(x)
        if fold:
            profiling.count(profiling.BN_FOLD_FOLDED, len(self._fold.pairs))
            return self.body.folded(x, self._fold.conv)
        if x.device.type in FOLD_DEVICES:
            profiling.count(profiling.BN_FOLD_PLAIN, self._n_pairs)
        return self.body(x)


def build_resnet(name: str, config: Dict[str, Any]) -> ResNetBackbone:
    return ResNetBackbone(variant=name.lower(),
                          in_channels=config.get("in_channels", 3),
                          multi_scale=config.get("multi_scale", 1))
