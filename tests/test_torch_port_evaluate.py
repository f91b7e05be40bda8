"""The port's serving CLI end to end on the CPU.

``python -m dpft_tpu_torch.evaluate --device cpu`` evaluates a port
checkpoint on the synthetic K-Radar fixture (prepared by the JAX package's
ETL) and writes the K-Radar txt tree and ``results.json``, which holds the
FLOPs of one forward and the parameter count. The default device is the
card: without one the CLI fails instead of running on the CPU.
"""

import json
import os
import os.path as osp
import subprocess
import sys

import pytest

from dpft_tpu.data import prepare as prepare_dataset
from dpft_tpu.utils.config import save_config
from dpft_tpu_torch.models import registry
from kradar_fixture import base_config, make_raw_kradar
from test_full_model_parity import tiny_config

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_eval"))
    processed = osp.join(root, "processed")
    config = base_config()
    prepare_dataset("kradar", config).prepare(make_raw_kradar(root),
                                              processed)
    config["model"] = tiny_config()["model"]
    config["evaluate"]["metrics"] = {}
    config["train"]["logging"] = "epoch"
    cfg = osp.join(root, "config.json")
    save_config(config, cfg)
    ckpt = osp.join(root, "run", "2026-01-01-00-00-00_checkpoint_0002.pt")
    registry.save(registry.build("dprt", config, device="cpu"), config, ckpt)
    return root, processed, cfg, ckpt


def _cli(processed, cfg, ckpt, dst, *extra):
    return subprocess.run(
        [sys.executable, "-m", "dpft_tpu_torch.evaluate", "--src", processed,
         "--cfg", cfg, "--checkpoint", ckpt, "--dst", dst, *extra],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=600)


def test_evaluate_cli_exports_on_cpu(fixture):
    root, processed, cfg, ckpt = fixture
    dst = osp.join(root, "log")
    proc = _cli(processed, cfg, ckpt, dst, "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert "Parameters=" in proc.stdout
    run = osp.join(dst, "2026-01-01-00-00-00")
    with open(osp.join(run, "results.json")) as f:
        results = json.load(f)
    assert results["FLOPS"] > 0 and results["Parameters"] > 0
    preds = osp.join(run, "exports", "kradar", "0.0", "all", "preds")
    assert sorted(os.listdir(preds))[0] == "000000.txt"


def test_evaluate_cli_needs_the_card_by_default(fixture):
    root, processed, cfg, ckpt = fixture
    proc = _cli(processed, cfg, ckpt, osp.join(root, "log_card"))
    assert proc.returncode != 0
    assert "CUDA card" in proc.stderr
