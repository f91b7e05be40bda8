"""Pretrained torchvision backbones of every family, from local files.

``dpft_tpu_torch/models/pretrained.py`` loads a torchvision state_dict
into a backbone that keeps the reference wrapper's key space. Each file
here is synthetic: the state_dict of ``tests/torch_refs.py``'s
transliteration of the torchvision model (torchvision's key names, the
classifier included; Swin's relative position index flattened as
torchvision stores it), randomized, written to ``tmp_path``; nothing is
downloaded. The backbones are built at two stages, so the file's stages 3
and 4 and its classifier have no module and are skipped; every key the
backbone has is loaded bit for bit, but the 1x1 adjustment conv of the
6-channel radar view, which keeps its seeded init; a file that lacks one
of the backbone's keys raises ``ValueError``. ResNet's file is held in
test_torch_port_model.py.
"""

import copy

import pytest
import torch

from chip_smoke import family_config
from dpft_tpu_torch.models import registry
from dpft_tpu_torch.models.pretrained import torchvision_keys
from test_full_model_parity import tiny_config
import torch_refs

FAMILIES = [("ConvNeXt_Tiny", "convnext", lambda: torch_refs.TorchConvNeXt()),
            ("Swin_T", "swin", lambda: torch_refs.TorchSwin()),
            ("RegNet_Y_400MF", "regnet",
             lambda: torch_refs.TorchRegNet("regnet_y_400mf"))]


def _torchvision_file(make, path, drop=None):
    torch.manual_seed(7)
    tv = make()
    torch_refs.randomize_bn_stats(tv, seed=1)
    state = {k: v.reshape(-1) if k.endswith("relative_position_index")
             else v for k, v in tv.state_dict().items()}
    if drop is not None:
        state = {k: v for k, v in state.items() if k != drop}
    torch.save(state, path)
    return state


@pytest.mark.parametrize("backbone,family,make", FAMILIES)
def test_torchvision_file_loads_into_the_wrapper(backbone, family, make,
                                                 tmp_path):
    state = _torchvision_file(make, tmp_path / f"{backbone.lower()}_TEST.pth")
    config = family_config(tiny_config(), backbone, multi_scale=2)
    config["computing"]["weights_dir"] = str(tmp_path)
    cfg = copy.deepcopy(config)
    for view in ("radar_bev", "camera_mono"):
        cfg["model"]["backbones"][view]["weights"] = "TEST"
    model = registry.build("dprt", cfg, device="cpu", seed=0)
    plain = registry.build("dprt", config, device="cpu", seed=0)
    mapped = torchvision_keys(family, state)
    for view in ("radar_bev", "camera_mono"):
        got = model.backbones[view].state_dict()
        loaded = [k for k in got if not k.startswith("adjustment_layer.")]
        assert loaded and set(loaded) < set(mapped)  # stages 3, 4 skipped
        for k in loaded:
            torch.testing.assert_close(got[k], mapped[k], rtol=0, atol=0,
                                       msg=k)
    torch.testing.assert_close(
        model.backbones["radar_bev"].adjustment_layer.weight,
        plain.backbones["radar_bev"].adjustment_layer.weight, rtol=0, atol=0)
    untouched = plain.backbones["radar_front"].state_dict()
    for k, v in model.backbones["radar_front"].state_dict().items():
        torch.testing.assert_close(v, untouched[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("backbone,family,make", FAMILIES)
def test_torchvision_file_without_a_key_raises(backbone, family, make,
                                               tmp_path):
    first = next(k for k in make().state_dict()
                 if k.startswith(("features.0.", "stem.0.")))
    _torchvision_file(make, tmp_path / f"{backbone.lower()}_TEST.pth",
                      drop=first)
    config = family_config(tiny_config(), backbone, multi_scale=2)
    config["computing"]["weights_dir"] = str(tmp_path)
    config["model"]["backbones"]["radar_bev"]["weights"] = "TEST"
    with pytest.raises(ValueError, match="lacks backbone keys"):
        registry.build("dprt", config, device="cpu", seed=0)
