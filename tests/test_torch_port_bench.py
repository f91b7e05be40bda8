"""``python -m dpft_tpu_torch.bench`` and ``bench_scaling`` on the CPU.

The bench is the counterpart of the root ``bench.py`` (the JAX package's)
and runs on the card only; its mode functions take ``config`` and
``device``, so they run here at the tiny config of test_full_model_parity
with 2 repetitions. Held: each mode's last line has the keys of the root
``bench.py``'s line for that mode, read from its source with ``ast``
(``chip_smoke.jax_bench_keys``), less ``readback_rtt_ms`` and the XLA
static memory keys, with ``mfu`` and ``peak_tflops`` for
``mfu_vs_bf16_peak`` and the card's name, power limit and activity added
(``chip_smoke.port_bench_keys``, which the card's run checks too); the
inference FLOPs are the evaluator's ``forward_flops``, the train step's
2-4 times the forward's; prepare reports the 4 frames of the tree that
``utils/example.py:write_raw_kradar`` writes at the fixture's shapes;
``"device"`` is ``"cpu"`` and every device metric null. bfloat16 runs on
the card only (``chip_smoke.py:phase_bench``): on the CPU a bfloat16
convolution of the tiny model now and then returns NaN from finite inputs
(torch's CPU kernel, channels-last input; the port's card path runs
cuDNN), which the bench's finiteness check turns into exit 1. ``main``
without a card prints the JSON error line, exits 1 and builds nothing;
the XLA step structures (``BENCH_HOIST`` and the others) exit 1 before
anything runs, even where a card is present. ``bench_scaling`` refuses
the ``hoist`` variant and records a cell that dies with its error. The
raw tree of ``write_raw_kradar`` has the fixture's layout, and the port's
prepare CLI reads it.
"""

import json
import os

import numpy as np
import pytest
import torch

from chip_smoke import SAMPLE_FILES, jax_bench_keys, port_bench_keys
from dpft_tpu_torch import bench, bench_scaling
from dpft_tpu_torch import prepare as prepare_cli
from dpft_tpu_torch.evaluation.evaluator import forward_flops
from dpft_tpu_torch.models import registry
from dpft_tpu_torch.utils.example import example_batch, write_raw_kradar
from kradar_fixture import (IMG_H, IMG_W, TESSERACT_SHAPE, TEST_IDS,
                            TRAIN_IDS, VAL_IDS, base_config, make_raw_kradar)
from test_full_model_parity import tiny_config

HW = {"cam_hw": (32, 48), "bev_hw": (32, 16), "front_hw": (16, 16)}
DEVICE_METRICS = ("achieved_tflops", "mfu", "peak_tflops", "peak_hbm_gb",
                  "power_limit_w", "launches_per_call", "device_busy_share",
                  "device_ms_per_call")


@pytest.fixture(scope="module")
def config():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    fixture = base_config()
    yield {**fixture, **tiny_config(),
           "computing": {**fixture["computing"], "seed": 0}}
    torch.set_num_threads(before)


def _cpu_line(result, mode):
    assert set(result) == port_bench_keys(mode)
    assert result["device"] == "cpu"
    assert all(result[k] is None for k in DEVICE_METRICS if k in result)
    assert json.loads(json.dumps(result)) == result


def test_port_keys_are_the_jax_line_with_the_listed_changes():
    jax = jax_bench_keys("inference")
    assert {"readback_rtt_ms", "hbm_static", "mfu_vs_bf16_peak",
            "forward_flops", "per_call_std_ms"} <= jax
    assert port_bench_keys("inference") == (
        jax - {"readback_rtt_ms", "hbm_static_gb", "hbm_static",
               "mfu_vs_bf16_peak"}
        | {"mfu", "peak_tflops", "device", "power_limit_w",
           "launches_per_call", "device_busy_share", "device_ms_per_call"})
    assert port_bench_keys("prepare") == jax_bench_keys("prepare") | {
        "device", "power_limit_w", "launches_per_call", "device_busy_share",
        "device_ms_per_call"}


def test_inference_line(config):
    result = bench.bench_inference(config, "cpu", 2, 2, 1, "", hw=HW)
    _cpu_line(result, "inference")
    model = registry.build("dprt", config, device="cpu", seed=0)
    batch = {k: torch.from_numpy(v)
             for k, v in example_batch(config, B=2, **HW).items()}
    assert result["forward_flops"] == forward_flops(model, batch)
    assert result["dtype"] == "float32" and result["batch"] == 2
    assert result["value"] > 0 and result["per_call_std_ms"] >= 0
    assert not torch.backends.cudnn.allow_tf32


def test_inference_without_flops(config):
    result = bench.bench_inference(config, "cpu", 1, 2, 1, "", flops=False,
                                   hw=HW)
    _cpu_line(result, "inference")
    assert result["forward_flops"] is None


@pytest.mark.parametrize("metric", [True, False])
def test_train_line(config, metric):
    result = bench.bench_train(config, "cpu", 2, 2, 1, "", flops=metric,
                               metric=metric, hw=HW)
    _cpu_line(result, "train")
    assert result["value"] > 0 and result["frames_per_sec"] > 0
    if metric:
        model = registry.build("dprt", config, device="cpu", seed=0)
        batch = {k: torch.from_numpy(v)
                 for k, v in example_batch(config, B=2, **HW).items()}
        ratio = result["grad_step_flops"] / forward_flops(model, batch)
        assert 2 <= ratio <= 4
    else:
        assert result["grad_step_flops"] is None
        assert result["flops_source"].startswith("not measured")


@pytest.mark.parametrize("prepare_device, baseline",
                         [("default", True), ("native", False)])
def test_prepare_line(config, prepare_device, baseline):
    result = bench.bench_prepare(base_config(), "cpu", "",
                                 prepare_device=prepare_device,
                                 baseline=baseline,
                                 cube_shape=TESSERACT_SHAPE,
                                 image_hw=(IMG_H, IMG_W))
    _cpu_line(result, "prepare")
    assert result["frames"] == 4 == len(bench.PREPARE_FRAMES)
    assert result["prepare_device"] == prepare_device
    assert (result["baseline_sec_per_frame"] is None) == (not baseline)
    assert result["value"] > 0 and result["raw_gb"] > 0


def test_prepare_frames_are_the_fixtures():
    assert bench.PREPARE_FRAMES == (*TRAIN_IDS, *VAL_IDS, *TEST_IDS)


@pytest.mark.parametrize("mode", sorted(bench.MODES))
def test_main_without_a_card_exits_1(mode, monkeypatch, capsys):
    for var in ("BENCH_HOIST", "BENCH_FLAT", "BENCH_FWD_ONCE", "BENCH_DTYPE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("BENCH_MODE", mode)

    def refuse(*args, **kwargs):
        raise AssertionError("the bench built a model without a card")

    monkeypatch.setattr(registry, "build", refuse)
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit) as exit_:
        bench.main()
    assert exit_.value.code == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"metric": bench.MODES[mode][0], "value": None,
                    "unit": bench.MODES[mode][1], "vs_baseline": None,
                    "error": "no CUDA device"}


@pytest.mark.parametrize("var", sorted(bench.REFUSED))
def test_xla_step_structures_are_refused(var, monkeypatch, capsys):
    """Refused before anything else, a card present or not."""
    monkeypatch.setenv(var, "1")
    monkeypatch.setenv("BENCH_MODE", "train")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit) as exit_:
        bench.main()
    assert exit_.value.code == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] is None and var in line["error"]
    assert bench.REFUSED[var] in line["error"]


def test_scaling_refuses_hoist_and_records_a_dead_cell(tmp_path):
    with pytest.raises(SystemExit, match="hoist"):
        bench_scaling.main([str(tmp_path / "x.jsonl"), "train",
                            "4:f32", "8:bf16:hoist"])
    assert not (tmp_path / "x.jsonl").exists()  # checked before running
    assert bench_scaling.parse_cell("8:bf16:nometric") == (8, "bf16",
                                                           "nometric")
    out = tmp_path / "cells.jsonl"
    row = bench_scaling.run_cell(str(out), "inference", 1, "f32")
    assert row["error"] == "no CUDA device" and row["value"] is None
    assert json.loads(out.read_text()) == row
    assert (row["mode"], row["batch"], row["dtype"]) == ("inference", 1,
                                                         "f32")


def test_raw_tree_has_the_fixture_layout_and_prepares(tmp_path):
    """``write_raw_kradar`` at the fixture's shapes writes the files of
    ``tests/kradar_fixture.py`` under the same names, and the port's
    prepare CLI turns them into the processed tree."""
    ids = bench.PREPARE_FRAMES
    src = write_raw_kradar(str(tmp_path / "ours"), ids,
                           cube_shape=TESSERACT_SHAPE,
                           image_hw=(IMG_H, IMG_W), seed=3)
    theirs = make_raw_kradar(str(tmp_path / "theirs"))

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(src) == files(theirs)
    from scipy.io import loadmat
    mat = os.path.join(src, "10", "radar_tesseract", "tesseract_00027.mat")
    cube = loadmat(mat)["arrDREA"]
    assert cube.shape == TESSERACT_SHAPE and cube.dtype == np.float64
    assert cube.min() > 0

    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        json.dump(base_config(), f)
    dst = str(tmp_path / "processed")
    prepare_cli.main(src, cfg, dst, device="cpu")
    for split, split_ids in (("train", TRAIN_IDS), ("val", VAL_IDS),
                             ("test", TEST_IDS)):
        for sid in split_ids:
            out = os.path.join(dst, split, "10", sid)
            assert sorted(os.listdir(out)) == sorted(SAMPLE_FILES)
            assert np.load(os.path.join(out, "ra.npy")).shape == (
                TESSERACT_SHAPE[1], TESSERACT_SHAPE[3], 6)
