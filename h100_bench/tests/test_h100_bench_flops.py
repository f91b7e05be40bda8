"""The harness's FLOP count against ``FlopCounterMode`` over the program
at a tiny size, and at the published sizes by arithmetic."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import BENCH
from harness import flops, program
from harness.inputs import make_requests


def _model(config):
    torch.manual_seed(0)
    model, _ = program.build_model(config, torch.device("cpu"), seed=1)
    return model


@pytest.mark.parametrize("batch", [1, 2])
def test_forward_matches_the_flop_counter(tiny_config, batch):
    model = _model(tiny_config).requires_grad_(False)
    shapes = tiny_config["bench"]["input_shapes"]
    req = make_requests(tiny_config, shapes, 1, batch, seed=3)[0]
    counter = FlopCounterMode(display=False)
    with counter:
        model({k: torch.as_tensor(v) for k, v in req.items()})
    assert counter.get_total_flops() == flops.forward_flops(
        tiny_config, shapes, batch)


def test_step_matches_the_flop_counter(tiny_config):
    """Forward and backward of a loss of the last head's outputs: what a
    train step's products and convolutions are."""
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
