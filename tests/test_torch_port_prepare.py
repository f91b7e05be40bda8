"""The port's prepare CLI against the JAX package's, on the CPU.

The raw mini K-Radar tree of tests/kradar_fixture.py goes through
``python -m dpft_tpu.prepare`` (NumPy reduction, ``use_device: false``) and
through ``python -m dpft_tpu_torch.prepare --device cpu`` (the plain PyTorch
reduction). Both must write the same directory tree; every file but the
radar planes byte for byte, ``ra.npy`` / ``ea.npy`` within rtol 3e-4 /
atol 3e-2 (float32 ``log10`` and the order of the sums differ).

The processor settles the radar reduction's route from ``use_device``,
``prepare_device`` and ``device`` once, and refuses an unknown
``prepare_device`` before it reads a file; every route that runs on the
CPU gives the NumPy reduction's planes. ``utils/example.py:
write_raw_kradar`` writes the fixture's raw layout.
"""

import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

from chip_smoke import SAMPLE_FILES
from dpft_tpu_torch import prepare as prepare_cli
from dpft_tpu_torch.data import prepare as prepare_dataset
from dpft_tpu_torch.ops.radar_reduce import reduce_tesseract_np
from dpft_tpu_torch.utils.example import write_raw_kradar
from kradar_fixture import (IMG_H, IMG_W, TESSERACT_SHAPE, TEST_IDS,
                            TRAIN_IDS, VAL_IDS, base_config, make_raw_kradar)

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


# (use_device, prepare_device, device) -> (route, device type). "cpu"
# overrides the device; "native" needs none, whatever the others say.
ROUTES = [
    ((True, "default", "cpu"), ("device", "cpu")),
    ((True, "default", "cuda"), ("device", "cuda")),
    ((True, "cpu", "cuda"), ("device", "cpu")),
    ((True, "native", "cuda"), ("native", None)),
    ((False, "default", "cuda"), ("numpy", None)),
    ((False, "cpu", "cpu"), ("numpy", None)),
    ((False, "native", "cpu"), ("native", None)),
]


@pytest.fixture(scope="module")
def tesseract_mat(tmp_path_factory):
    from scipy.io import savemat

    path = str(tmp_path_factory.mktemp("route") / "tesseract.mat")
    cube = np.random.default_rng(5).uniform(1e8, 1e12, size=TESSERACT_SHAPE)
    savemat(path, {"arrDREA": cube})
    return path


@pytest.mark.parametrize("keys, want", ROUTES,
                         ids=["-".join(map(str, k)) for k, _ in ROUTES])
def test_prepare_route(keys, want, tesseract_mat, monkeypatch):
    """One route per combination of the keys; where it runs on the CPU its
    planes are the NumPy reduction's (exactly on the NumPy route). A card
    route is only chosen here: ``torch.cuda.is_available`` is patched to
    say there is one."""
    use_device, prepare_device, device = keys
    config = base_config()
    config["computing"]["device"] = device
    config["data"]["use_device"] = use_device
    config["data"]["prepare_device"] = prepare_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    processor = prepare_dataset("kradar", config)
    got = (processor.route,
           processor.device and processor.device.type)
    assert got == want
    if want[1] == "cuda":
        return
    from scipy.io import loadmat

    planes = processor.get_radar_data(tesseract_mat)
    cube = loadmat(tesseract_mat)["arrDREA"].astype(np.float32)
    for x, y in zip(planes, reduce_tesseract_np(cube)):
        y = y.astype(np.float32)
        assert x.dtype == np.float32 and x.shape == y.shape
        if want[0] == "numpy":
            np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_allclose(x, y, **TOL)


@pytest.mark.parametrize("prepare_device", ["cuda", "Native", ""])
def test_unknown_prepare_device_raises(prepare_device):
    """At construction, before ``prepare`` reads any file."""
    config = base_config()
    config["computing"]["device"] = "cpu"
    config["data"]["prepare_device"] = prepare_device
    with pytest.raises(ValueError, match="'default', 'cpu', 'native'"):
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


def test_device_path_casts_on_the_device_not_on_the_host(prepared,
                                                         monkeypatch):
    """With ``use_device`` the cube goes to the device as ``loadmat`` gives
    it (float64, doppler-fastest) and is cast there: no ``astype`` of the
    cube on the host. The NumPy path still casts on the host, once."""
    import scipy.io
    import torch

    import dpft_tpu_torch.data.kradar.processor as processor_module

    src = prepared[0]
    mat = osp.join(src, "10", "radar_tesseract",
                   sorted(os.listdir(osp.join(src, "10",
                                              "radar_tesseract")))[0])
    casts, seen = [], []

    class Counting(np.ndarray):
        def astype(self, dtype, *args, **kwargs):
            casts.append(np.dtype(dtype))
            return np.asarray(self).astype(dtype, *args, **kwargs)

    loadmat = scipy.io.loadmat

    def counting_loadmat(filename):
        return {"arrDREA": loadmat(filename)["arrDREA"].view(Counting)}

    reduce = processor_module.reduce_tesseract

    def spy(cube):
        seen.append((cube.dtype, tuple(cube.stride())))
        return reduce(cube)

    monkeypatch.setattr(scipy.io, "loadmat", counting_loadmat)
    config = base_config()
    config["computing"]["device"] = "cpu"
    processor = prepare_dataset("kradar", config)
    monkeypatch.setattr(processor_module, "reduce_tesseract", spy)
    ra, ea = processor.get_radar_data(mat)
    D, R, E, A = TESSERACT_SHAPE
    assert casts == []
    assert seen == [(torch.float64, (1, D, D * R, D * R * E))]
    assert ra.dtype == ea.dtype == np.float32
    assert ra.shape == (R, A, 6) and ea.shape == (E, A, 6)

    config["data"]["use_device"] = False
    ra_np, ea_np = prepare_dataset("kradar", config).get_radar_data(mat)
    assert casts == [np.dtype(np.float32)] and len(seen) == 1
    np.testing.assert_allclose(ra, ra_np, **TOL)
    np.testing.assert_allclose(ea, ea_np, **TOL)


def test_raw_tree_has_the_fixture_layout_and_prepares(tmp_path):
    """``write_raw_kradar`` at the fixture's shapes writes the files of
    ``tests/kradar_fixture.py`` under the same names, and the port's
    prepare CLI turns them into the processed tree."""
    ids = (*TRAIN_IDS, *VAL_IDS, *TEST_IDS)
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
