"""chip_smoke.py's overfit recipe against the tests' own, on the CPU.

``chip_smoke.write_fixture_tree`` writes tests/kradar_fixture.py's raw
tree without importing it or the JAX package, so that the card's
``phase_overfit`` and the CPU's overfit tests start from the same data:
the same files, every text file byte for byte, the arrays of every
tesseract, image and point cloud equal; with the recipe's boxes, the
labels of tests/test_overfit_metrics.py:_write_boxes byte for byte. Its
``overfit_config`` is that test's config key for key.
"""

import os
import os.path as osp

import cv2
import numpy as np
import pytest
from scipy.io import loadmat

import chip_smoke
from dpft_tpu_torch.data.pcd import read_pcd
from kradar_fixture import base_config, make_raw_kradar
from test_e2e import small_model_config
from test_overfit_metrics import EPOCHS, _write_boxes


def _files(root):
    return sorted(osp.relpath(osp.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_fixture_writer_writes_the_fixture(tmp_path):
    got = chip_smoke.write_fixture_tree(str(tmp_path / "card"))
    want = make_raw_kradar(str(tmp_path / "tests"))
    files = _files(want)
    assert _files(got) == files
    assert len(files) == 4 * 5 + 3
    for rel in files:
        a, b = osp.join(got, rel), osp.join(want, rel)
        if rel.endswith(".txt"):
            assert _read(a) == _read(b), rel
        elif rel.endswith(".mat"):
            x, y = loadmat(a)["arrDREA"], loadmat(b)["arrDREA"]
            assert x.shape == chip_smoke.FIXTURE_CUBE, rel
            np.testing.assert_array_equal(x, y, err_msg=rel)
        elif rel.endswith(".png"):
            x, y = cv2.imread(a), cv2.imread(b)
            assert x.shape == (64, 192, 3), rel
            np.testing.assert_array_equal(x, y, err_msg=rel)
        else:
            assert rel.endswith(".pcd"), rel
            x, y = read_pcd(a), read_pcd(b)
            assert list(x) == list(y), rel
            for k in y:
                np.testing.assert_array_equal(x[k], y[k], err_msg=rel)


@pytest.mark.parametrize("two_class", [False, True])
def test_fixture_writer_writes_the_overfit_labels(tmp_path, two_class):
    got = chip_smoke.write_fixture_tree(str(tmp_path / "card"), two_class)
    want = make_raw_kradar(str(tmp_path / "tests"))
    _write_boxes(want, two_class)
    labels = osp.join(chip_smoke.SEQUENCE, "info_label_v2")
    names = sorted(os.listdir(osp.join(want, labels)))
    assert sorted(os.listdir(osp.join(got, labels))) == names
    for name in names:
        assert _read(osp.join(got, labels, name)) == \
            _read(osp.join(want, labels, name)), name


def _jax_tests_config(two_class):
    """tests/test_overfit_metrics.py:_overfit's config, as it builds it."""
    config = small_model_config(base_config())
    config["train"]["epochs"] = EPOCHS
    config["train"]["optimizer"]["lr"] = 3e-3
    config["train"]["loss_weights"] = {
        "total_class": 2.0, "object_class": 1.0,
        "center": 1.0, "size": 1.0, "angle": 1.0}
    if two_class:
        config["data"]["num_classes"] = 3
        config["model"]["head"]["num_classes"] = 3
        config["data"]["categories"]["Bus or Truck"] = 1
    config["train"]["evaluating"] = -1
    return config


@pytest.mark.parametrize("two_class", [False, True])
def test_overfit_config_is_the_jax_tests(two_class):
    want = _jax_tests_config(two_class)
    assert chip_smoke.overfit_config(two_class) == want
    mm = chip_smoke.overfit_config(two_class, mm=True, seed=3)
    assert mm["model"]["fuser"].pop("pallas_msda") == "mm"
    assert mm["computing"].pop("seed") == 3
    want["computing"].pop("seed")
    assert mm == want
