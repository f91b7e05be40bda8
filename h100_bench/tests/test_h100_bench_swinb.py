"""The Swin-B camera cell ``kradar_swinb.serve.b1`` and its two per-layer
metrics of the window attention.

- The cell loads through ``spec.load_cell`` with ``serve_p95_ms`` and
  ``setup_s``, every serve per-layer metric and its check; its
  configuration is the published ``config/kradar.json`` with only the
  camera's backbone and its FPN's ``in_channels_list`` changed, and the
  Swin-B fixture ``tests/kradar_swinb.json`` with the benchmark's notes of
  a cell; the harness counts it as ``FlopCounterMode`` counted the program
  on the card.
- On the tiny Swin cell on the CPU, where every block runs the plain
  operations, ``window_attention.fused_share.serve`` reads 0 and
  ``window_attention_roofline.serve`` reads nothing (no ``window_attn_``
  kernel ran); with the fused path forced, the share reads 100.
"""

import json

import pytest
import torch

from conftest import BENCH, ROOT, load_tiny
from harness import flops, spec
from test_h100_bench_cells import drive, tiny_cell

CELL = "kradar_swinb.serve.b1"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ("window_attention_roofline.serve",
       "window_attention.fused_share.serve")


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_the_cell_loads_with_every_serve_metric():
    cell = spec.load_cell(ROOT, CELL)
    assert cell.chips == 1 and cell.traffic_name == "serve-b1"
    assert [m["name"] for m in cell.end_to_end] == ["serve_p95_ms",
                                                    "setup_s"]
    serve = [m["name"] for m in SPEC["per_layer"]
             if m["moves"] == "serve_p95_ms"]
    assert [m["name"] for m in cell.per_layer] == serve
    assert set(NEW) <= set(serve)
    assert cell.limits == {"serve_out_gap": 2e-4}
    for m in cell.per_layer:
        assert spec.reader(m["name"]).read is not None


def test_the_configuration_is_the_swin_b_fixture():
    cell = spec.load_cell(ROOT, CELL)
    fixture = json.loads((BENCH / "tests" / "kradar_swinb.json").read_text())
    config = dict(cell.config)
    assert config.pop("bench")["input_shapes"] == \
        fixture.pop("bench")["input_shapes"]
    assert config.pop("notes").startswith("Derived, not published")
    assert config == fixture
    assert config["model"]["backbones"]["camera_mono"]["name"] == "Swin_B"
    entry = {c["name"]: c for c in SPEC["configs"]}["kradar_swinb"]
    assert entry["reduced"] == ["computing", "dataset"]


def test_the_configuration_is_the_published_kradar_with_a_swin_b_camera():
    published = json.loads((ROOT / "config" / "kradar.json").read_text())
    config = json.loads((BENCH / "configs" / "kradar_swinb.json").read_text())
    del config["bench"], config["notes"]
    camera = published["model"]["backbones"]["camera_mono"]
    assert config["model"]["backbones"]["camera_mono"] == {
        "name": "Swin_B", "weights": "IMAGENET1K_V1",
        "multi_scale": camera["multi_scale"]}
    assert config["model"]["necks"]["camera_mono"]["in_channels_list"] == \
        [3, 128, 256, 512, 1024]
    for part in (published, config):
        del part["model"]["backbones"]["camera_mono"]
        del part["model"]["necks"]["camera_mono"]["in_channels_list"]
    assert config == published


def test_the_harness_counts_the_cell_as_the_card_runs_read():
    cell = spec.load_cell(ROOT, CELL)
    # FlopCounterMode's count of the program's B=1 forward on the card
    # (flops_check.py --file tests/kradar_swinb.json).
    assert flops.forward_flops(cell.config, cell.input_shapes, 1) == \
        318_763_045_116
    bound = flops.window_attention_bound_s(cell.config, cell.input_shapes, 1)
    assert bound == pytest.approx(165.7e-6, abs=0.05e-6)


def _swin_cell():
    return tiny_cell(CELL, load_tiny("swin"))


def test_new_readers_on_the_tiny_swin_cell():
    result, _ = drive(_swin_cell(), trace=True)
    assert result["correct"]
    metrics = result["metrics"]
    assert metrics["window_attention.fused_share.serve"]["value"] == 0
    assert "window_attention_roofline.serve" not in metrics


def test_fused_share_reads_100_where_every_block_takes_the_operator(
        monkeypatch):
    from dpft_tpu_torch.models.backbones import swin

    monkeypatch.setattr(swin, "fused", lambda qkv: not
                        torch.is_grad_enabled())
    result, _ = drive(_swin_cell(), trace=True)
    assert result["correct"]
    assert result["metrics"]["window_attention.fused_share.serve"][
        "value"] == 100
