"""The harness's FLOP count against ``FlopCounterMode`` over the program
at a tiny size (a ResNet and a Swin camera), and at the published sizes
by arithmetic."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import BENCH, TINY, load_tiny
from harness import flops, program
from harness.inputs import make_requests
from reference import dpft_ref


def _model(config):
    torch.manual_seed(0)
    model, _ = program.build_model(config, torch.device("cpu"), seed=1)
    return model


@pytest.mark.parametrize("kind", list(TINY))
@pytest.mark.parametrize("batch", [1, 2])
def test_forward_matches_the_flop_counter(kind, batch):
    tiny_config = load_tiny(kind)
    model = _model(tiny_config).requires_grad_(False)
    shapes = tiny_config["bench"]["input_shapes"]
    req = make_requests(tiny_config, shapes, 1, batch, seed=3)[0]
    counter = FlopCounterMode(display=False)
    with counter:
        model({k: torch.as_tensor(v) for k, v in req.items()})
    assert counter.get_total_flops() == flops.forward_flops(
        tiny_config, shapes, batch)


@pytest.mark.parametrize("kind", list(TINY))
def test_step_matches_the_flop_counter(kind):
    """Forward and backward of a loss of the last head's outputs: what a
    train step's products and convolutions are."""
    tiny_config = load_tiny(kind)
    model = _model(tiny_config).train()
    shapes = tiny_config["bench"]["input_shapes"]
    req = make_requests(tiny_config, shapes, 1, 2, seed=3)[0]
    counter = FlopCounterMode(display=False)
    with counter:
        out = model({k: torch.as_tensor(v) for k, v in req.items()})
        sum(v.sum() for v in out.values()).backward()
    assert counter.get_total_flops() == flops.step_flops(tiny_config, shapes,
                                                         2)


def test_published_sizes():
    """The counts the program's ``FlopCounterMode`` gave on the card for
    ``config/kradar.json`` (PERF.md): 155,427,456,252 per B=1 forward and
    1,856,369,337,312 per B=4 train step."""
    config = json.loads((BENCH / "configs" / "kradar.json").read_text())
    shapes = config["bench"]["input_shapes"]
    assert flops.forward_flops(config, shapes, 1) == 155_427_456_252
    assert flops.step_flops(config, shapes, 4) == 1_856_369_337_312
    radar = json.loads((BENCH / "configs" / "kradar_radar.json").read_text())
    assert flops.forward_flops(radar, radar["bench"]["input_shapes"],
                               1) == 6_091_105_532


def test_bounds_from_shapes():
    config = json.loads((BENCH / "configs" / "kradar.json").read_text())
    shapes = config["bench"]["input_shapes"]
    # Every MSDA call moves more bytes than it computes at 67 TFLOP/s.
    assert flops.msda_bound_s(config, shapes, 1) == pytest.approx(
        7.889385e-6, rel=1e-6)
    # The radar planes read 260.1 MB and 251.4 MB of a K-Radar cube.
    assert flops.radar_bound_s((64, 256, 37, 107), (4, 252)) == pytest.approx(
        (259_457_024 + 657_408 + 251_348_992 + 95_016) / 3.35e12)


def _swin_b():
    return json.loads((BENCH / "tests" / "kradar_swinb.json").read_text())


def test_swin_b_sizes():
    """The Swin-B DPFT at 512x910: the camera's levels (floor at the patch
    convolution, ceiling at each merge), its trunk's 308.95 GFLOP, of
    which 6.66 the window attention's two products, over 627 windows in
    stage 1."""
    config = _swin_b()
    shapes = config["bench"]["input_shapes"]
    assert flops.level_shapes(config, shapes)[0] == [
        (512, 910), (128, 227), (64, 114), (32, 57), (16, 29)]
    c = flops.Count()
    flops.swin_levels(c, 1, "swin_b", 3, 512, 910, 4)
    assert c.forward == 308_950_780_928
    stages = flops.swin_stages("swin_b", 512, 910, 4)
    assert sum(2 * 2 * flops._padded(st.h) * flops._padded(st.w) * 49
               * st.dim * st.blocks for st in stages) == 6_655_495_168
    assert flops._padded(128) * flops._padded(227) // 49 == 627
    assert flops.forward_flops(config, shapes, 1) == 318_763_045_116
    assert flops.forward_flops(config, shapes, 4) == 1_275_052_180_464


def test_window_attention_bound():
    """Every Swin-B block is bound by its bytes; a config without a Swin
    trunk has no windowed attention."""
    config = _swin_b()
    shapes = config["bench"]["input_shapes"]
    # Stage 1 at B=1: 627 windows of 49 tokens, 128 channels: q, k, v and
    # the output 62.9 MB, the mask 6.0 MB, against 0.77 GFLOP.
    st = flops.swin_stages("swin_b", 512, 910, 4)[0]
    tokens = 627 * 49
    moved = 4 * tokens * 128 * 4 + 169 * 4 * 4 + 627 * 49 ** 2 * 4
    assert 4 * tokens * 49 * 128 / flops.PEAK_F32_FLOPS < (
        moved / flops.PEAK_HBM_BYTES_PER_S)
    assert st.shifted(1) and not st.shifted(0)
    assert flops.window_attention_bound_s(config, shapes, 1) == (
        pytest.approx(1.657456632835821e-4, rel=1e-9))
    assert flops.window_attention_bound_s(config, shapes, 4) == (
        pytest.approx(6.522881062686566e-4, rel=1e-9))
    kradar = json.loads((BENCH / "configs" / "kradar.json").read_text())
    assert flops.window_attention_bound_s(
        kradar, kradar["bench"]["input_shapes"], 1) == 0.0


@pytest.mark.parametrize("name,kind", [("ConvNeXt_Tiny", "convnext"),
                                       ("RegNet_Y_400MF", "regnet")])
def test_families_without_a_count_raise(name, kind):
    """The FLOP count and the reference cover ResNet and Swin; another
    family fails loudly, naming itself, in both."""
    config = load_tiny("resnet")
    config["model"]["backbones"]["camera_mono"]["name"] = name
    shapes = config["bench"]["input_shapes"]
    with pytest.raises(ValueError, match=kind):
        flops.forward_flops(config, shapes, 1)
    with pytest.raises(ValueError, match=kind):
        flops.window_attention_bound_s(config, shapes, 1)
    with pytest.raises(ValueError, match=kind):
        dpft_ref.backbone({}, "backbones.camera_mono",
                          torch.zeros(1, 3, 32, 48), name, 4, dpft_ref.Ctx())
