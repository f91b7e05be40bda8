"""The port's prepare CLI against the JAX package's, on the CPU.

The raw mini K-Radar tree of tests/kradar_fixture.py goes through
``python -m dpft_tpu.prepare`` (NumPy reduction, ``use_device: false``) and
through ``python -m dpft_tpu_torch.prepare --device cpu`` (the plain PyTorch
reduction). Both must write the same directory tree; every file but the
radar planes byte for byte, ``ra.npy`` / ``ea.npy`` within rtol 3e-4 /
atol 3e-2 (float32 ``log10`` and the order of the sums differ).
"""

import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest

from dpft_tpu_torch.data import prepare as prepare_dataset
from kradar_fixture import (TESSERACT_SHAPE, TEST_IDS, TRAIN_IDS, VAL_IDS,
                            base_config, make_raw_kradar)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TOL = dict(rtol=3e-4, atol=3e-2)
EXACT_ARRAYS = ["labels.npy", "description.npy", "mono_info.npy",
                "stereo_info.npy", "ra_info.npy", "ea_info.npy", "os1.npy",
                "os2.npy"]
IMAGES = ["mono.jpg", "stereo.jpg"]
PLANES = ["ra.npy", "ea.npy"]
SAMPLES = ([("train", s) for s in TRAIN_IDS] + [("val", s) for s in VAL_IDS]
           + [("test", s) for s in TEST_IDS])


def _cli(module, src, cfg, dst, *extra):
    return subprocess.run(
        [sys.executable, "-m", module, "--src", src, "--cfg", cfg, "--dst",
         dst, *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="",
                 JAX_PLATFORMS="cpu"))


def _tree(root):
    return sorted(osp.relpath(osp.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("port_prepare"))
    src = make_raw_kradar(root)
    config = base_config()
    cfg = osp.join(root, "config.json")
    with open(cfg, "w") as f:
        json.dump(config, f)
    config["data"]["use_device"] = False
    cfg_numpy = osp.join(root, "config_numpy.json")
    with open(cfg_numpy, "w") as f:
        json.dump(config, f)
    want, got = osp.join(root, "jax"), osp.join(root, "port")
    proc = _cli("dpft_tpu.prepare", src, cfg_numpy, want)
    assert proc.returncode == 0, proc.stderr
    proc = _cli("dpft_tpu_torch.prepare", src, cfg, got, "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    return src, cfg, want, got


def test_same_directory_tree(prepared):
    _, _, want, got = prepared
    assert _tree(got) == _tree(want)
    assert len(_tree(got)) == 12 * len(SAMPLES)


@pytest.mark.parametrize("split,sample", SAMPLES)
def test_sample_files_match(prepared, split, sample):
    _, _, want, got = prepared
    a, b = (osp.join(root, split, "10", sample) for root in (got, want))
    for name in EXACT_ARRAYS:
        x, y = np.load(osp.join(a, name)), np.load(osp.join(b, name))
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    for name in IMAGES:
        with open(osp.join(a, name), "rb") as fa, \
                open(osp.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    D, R, E, A = TESSERACT_SHAPE
    for name, shape in zip(PLANES, ((R, A, 6), (E, A, 6))):
        x, y = np.load(osp.join(a, name)), np.load(osp.join(b, name))
        assert x.shape == y.shape == shape and x.dtype == y.dtype, name
        np.testing.assert_allclose(x, y, **TOL, err_msg=name)
        np.testing.assert_array_equal(x[..., 3], y[..., 3], err_msg=name)


def test_numpy_path_writes_the_same_planes_exactly(prepared, tmp_path):
    """``use_device: false`` is the same NumPy code in both packages."""
    src, _, want, _ = prepared
    config = base_config()
    config["data"]["use_device"] = False
    config["computing"]["workers"] = 1
    dst = str(tmp_path / "numpy")
    prepare_dataset("kradar", config).prepare(src, dst)
    for split, sample in SAMPLES:
        for name in PLANES:
            np.testing.assert_array_equal(
                np.load(osp.join(dst, split, "10", sample, name)),
                np.load(osp.join(want, split, "10", sample, name)))


def test_prepare_device_cpu_overrides_the_device():
    config = base_config()
    config["computing"]["device"] = "cuda"
    config["data"]["prepare_device"] = "cpu"
    assert prepare_dataset("kradar", config).device.type == "cpu"


def test_prepare_device_native_is_not_ported():
    config = base_config()
    config["data"]["prepare_device"] = "native"
    with pytest.raises(NotImplementedError, match="native"):
        prepare_dataset("kradar", config)


def test_unknown_dataset_raises():
    with pytest.raises(ValueError, match="Unknown dataset"):
        prepare_dataset("nuscenes", base_config())


def test_prepare_cli_needs_the_card_by_default(prepared, tmp_path):
    src, cfg, _, _ = prepared
    dst = str(tmp_path / "card")
    proc = _cli("dpft_tpu_torch.prepare", src, cfg, dst)
    assert proc.returncode != 0
    assert "CUDA card" in proc.stderr
    assert not osp.exists(dst)
