"""DPFT top-level model: per-view backbone, skiplink, FPN, positional
embedding, querent, and the iterative fusion decoder with its heads.

Counterpart of dpft_tpu/models/dpft.py, with the same batch contract: for
every configured input the batch holds ``<input>`` (B, H, W, C) data,
``label_to_<input>_t`` (B, 4, 4) and ``label_to_<input>_p`` (B, R, 4)
matrices, and ``<input>_shape`` (B, 3) raw shapes. The output is the head
dict (class / center / size / angle), float32.

The NHWC inputs are permuted to NCHW at entry; the permuted view keeps
channels_last memory, which cuDNN convolves directly. With
``computing.compute_dtype: bfloat16`` the forward runs under autocast:
parameters stay float32, matmuls and convolutions run in bfloat16, softmax
and LayerNorm in float32.

With ``computing.remat: true`` each backbone runs under
``torch.utils.checkpoint`` (the counterpart of the JAX package's
``_maybe_remat``, flax's lifted remat of the backbones only): its
activations are dropped after the forward and recomputed in the backward,
less memory for more FLOPs, with the same gradients and the same
state_dict keys. The recompute leaves BatchNorm's running statistics and
counters as the forward left them (JAX's remat commits ``batch_stats``
once).

CUDA graphs (``models/graphs.py``). Each view's backbone, neck and
embedding and the fuser (its four fusion iterations, their MSDA calls, the
reductions and the heads) are stages: called as modules, as here, each
replays one CUDA graph per input layout instead of launching its
operations one by one. A stage replays when its inputs are on a CUDA
device, the model is in ``eval()``, grad is off (``inference_mode`` or
``no_grad``), no ``TorchFunctionMode`` / ``TorchDispatchMode`` is active
(``FlopCounterMode``) and nothing exports, compiles or traces; from the
third call of a key on (the first runs eagerly, the second captures). In
every other case (the CPU, training, ``torch.export``, the FLOP count,
remat's checkpointed backbones) it runs eagerly as before. Replays read the
weights in place; moving or rebinding a parameter or buffer drops the
graphs. The querent launches nothing after its first call (its grid or
its parameter, broadcast to the batch) and is not a stage. The module tree
and the state_dict keys are those without graphs, and hooks on the stage
modules fire around each replay as around an eager call. Spans inside a
stage (the fuser's) record only when it runs eagerly.

Spans (``utils/profiling.py``): ``dpft.forward`` holds ``dpft.frontend``
(``features``; per view ``v`` in input order
``dpft.frontend.view<v>.backbone`` (in a Swin trunk, per stage ``s``
``.backbone.stage<s>``) / ``.neck`` / ``.embedding``) and
``dpft.decoder`` (``dpft.decoder.querent`` and the fuser's spans). Under
remat the recomputed backbone opens its span again inside the backward.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Sequence

import torch
import torch.nn as nn
import torch.utils.checkpoint

from dpft_tpu_torch.models.backbones import build_backbone
from dpft_tpu_torch.models.embeddings import build_embedding
from dpft_tpu_torch.models.fusers import build_fuser
from dpft_tpu_torch.models.fusers.mpfusion import ViewFeatures
from dpft_tpu_torch.models.heads import build_detection_head
from dpft_tpu_torch.models.layers.common import get_compute_dtype
from dpft_tpu_torch.models.necks import build_neck
from dpft_tpu_torch.models.queries import build_querent
from dpft_tpu_torch.utils.profiling import span
# Moved to utils/profiling.py; importable from here as before.
from dpft_tpu_torch.utils.profiling import parameter_count  # noqa: F401


class DPFT(nn.Module):
    def __init__(self, inputs: Sequence[str], skiplinks: Dict[str, bool],
                 backbones: Dict[str, nn.Module], necks: Dict[str, nn.Module],
                 embeddings: Dict[str, nn.Module], querent: nn.Module,
                 fuser: nn.Module, compute_dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.inputs = list(inputs)
        self.skiplinks = dict(skiplinks)
        self.backbones = nn.ModuleDict(backbones)
        self.necks = nn.ModuleDict(necks)
        self.embeddings = nn.ModuleDict(embeddings)
        self.querent = querent
        self.fuser = fuser
        self.compute_dtype = compute_dtype
        self.remat = remat
        # Per view: the spans of its backbone, neck and embedding.
        self._spans = [tuple(f"dpft.frontend.view{v}.{part}" for part in
                             ("backbone", "neck", "embedding"))
                       for v in range(len(self.inputs))]

    def _backbone(self, name: str, raw: torch.Tensor,
                  label: str) -> Dict[str, Any]:
        backbone = self.backbones[name]
        if not (self.remat and torch.is_grad_enabled()):
            return _spanned(label, backbone, raw)
        return torch.utils.checkpoint.checkpoint(
            _spanned, label, backbone, raw, use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(),
                                _buffers_kept(backbone)))

    def features(self, batch: Dict[str, torch.Tensor]) -> List[ViewFeatures]:
        """Per view: the embedded FPN levels, flattened to (B, Len, C), and
        their (h, w) shapes in level order."""
        views = []
        with span("dpft.frontend"):
            for name, (backbone, neck, embedding) in zip(self.inputs,
                                                         self._spans):
                raw = batch[name].permute(0, 3, 1, 2)  # NHWC -> NCHW view
                feats = self._backbone(name, raw, backbone)
                if self.skiplinks.get(name, False):
                    feats = {"0": raw, **feats}  # raw data becomes level '0'
                with span(neck):
                    feats = self.necks[name](feats)
                with span(embedding):
                    feats = self.embeddings[name](feats)
                    shapes = tuple((t.shape[2], t.shape[3])
                                   for t in feats.values())
                    flat = torch.cat([t.permute(0, 2, 3, 1).reshape(
                        t.shape[0], -1, t.shape[1]) for t in feats.values()],
                        dim=1)
                views.append((flat, shapes))
        return views

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        device = batch[self.inputs[0]].device
        with span("dpft.forward"), torch.autocast(
                device.type, dtype=self.compute_dtype,
                enabled=self.compute_dtype != torch.float32):
            views = self.features(batch)
            with span("dpft.decoder"):
                B = batch[self.inputs[0]].shape[0]
                with span("dpft.decoder.querent"):
                    out = self.querent(B, device)
                projection = [(batch[f"label_to_{n}_t"],
                               batch[f"label_to_{n}_p"]) for n in self.inputs]
                shape = [batch[f"{n}_shape"][:, :2].float()
                         for n in self.inputs]
                return self.fuser(views, shape, projection, out)


def _spanned(label: str, module: nn.Module, x: torch.Tensor) -> Any:
    with span(label):
        return module(x)


@contextlib.contextmanager
def _buffers_kept(module: nn.Module) -> Iterator[None]:
    """Restores ``module``'s buffers after the body: what a recompute of
    its forward in train mode adds to BatchNorm's running statistics and
    ``num_batches_tracked`` is taken back."""
    saved = [(b, b.clone()) for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for buffer, value in saved:
                buffer.copy_(value)


def from_config(config: Dict[str, Any]) -> DPFT:
    """Builds the DPFT module tree from a kradar*.json-style config.

    Sub-configs are merged with the 'computing' section and dispatched by
    their 'name' string, as in the JAX package.
    """
    computing = config.get("computing", {})
    model = config["model"]

    def merged(sub):
        return dict(computing | sub)

    head = build_detection_head(model["head"]["name"],
                                merged(model["head"]))
    return DPFT(
        inputs=model["inputs"],
        skiplinks=model.get("skiplinks", {}),
        backbones={k: build_backbone(v["name"], merged(v))
                   for k, v in model.get("backbones", {}).items()},
        necks={k: build_neck(v["name"], merged(v))
               for k, v in model.get("necks", {}).items()},
        embeddings={k: build_embedding(v["name"], merged(v))
                    for k, v in model.get("embeddings", {}).items()},
        querent=build_querent(model["querent"]["name"],
                              merged(model["querent"])),
        fuser=build_fuser(model["fuser"]["name"], merged(model["fuser"]),
                          head=head),
        compute_dtype=get_compute_dtype(computing),
        remat=bool(computing.get("remat", False)),
    )
