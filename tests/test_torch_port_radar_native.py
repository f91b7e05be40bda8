"""The port's host radar reduction (``prepare_device: "native"``,
dpft_tpu_torch/ops/radar_reduce_native.py over csrc/radar_reduce_host.cc)
against the port's plain version and the JAX package's own binding.

The shapes and tolerances of tests/test_radar_native.py (rtol 2e-4 /
atol 2e-2: -Ofast's vectorized log10f against numpy's float32 one). The
library is built into build/kernels/ and nothing is written into native/.
The prepare CLI with ``"native"`` writes the files of its ``"cpu"`` run:
every file but the radar planes byte for byte, the planes within that
tolerance.
"""

import json
import os
import os.path as osp

import numpy as np
import pytest
import torch

from dpft_tpu.ops.radar_reduce_native import \
    reduce_tesseract_native as jax_native
from dpft_tpu_torch.ops import radar_reduce_native as port_native
from dpft_tpu_torch.ops.radar_reduce import reduce_tesseract_plain
from kradar_fixture import base_config, make_raw_kradar
from test_torch_port_prepare import (EXACT_ARRAYS, IMAGES, PLANES, SAMPLES,
                                     _cli, _tree)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-2)


def _native_dir():
    d = osp.join(ROOT, "native")
    return {n: os.stat(osp.join(d, n)).st_mtime_ns for n in os.listdir(d)}


@pytest.mark.parametrize("shape", [(8, 32, 6, 10), (8, 32, 7, 19),
                                   (6, 16, 5, 11)])
def test_native_matches_plain_and_jax_binding(shape):
    rng = np.random.default_rng(11)
    tess = rng.uniform(1e8, 1e12, size=shape).astype(np.float32)
    before = _native_dir()
    ra, ea = port_native.reduce_tesseract_native(tess)
    assert _native_dir() == before
    want_ra, want_ea = (t.numpy() for t in
                        reduce_tesseract_plain(torch.from_numpy(tess)))
    np.testing.assert_allclose(ra, want_ra, **TOL)
    np.testing.assert_allclose(ea, want_ea, **TOL)
    jax_ra, jax_ea = jax_native(tess)
    np.testing.assert_array_equal(ra, jax_ra)
    np.testing.assert_array_equal(ea, jax_ea)


def test_native_rejects_nonpositive_powers():
    tess = np.random.default_rng(1).uniform(
        1e8, 1e12, size=(4, 8, 3, 5)).astype(np.float32)
    tess[1, 2, 1, 3] = 0.0
    with pytest.raises(ValueError, match="strictly positive"):
        port_native.reduce_tesseract_native(tess)


def test_library_is_built_under_build_kernels():
    port_native.load_library()
    built = os.listdir(osp.join(ROOT, "build", "kernels"))
    assert any(n.startswith("libradar_host_") and n.endswith(".so")
               for n in built)


def test_prepare_cli_native_equals_cpu(tmp_path):
    root = str(tmp_path)
    src = make_raw_kradar(root)
    paths = {}
    for mode in ("cpu", "native"):
        config = base_config()
        config["data"]["prepare_device"] = mode
        cfg = osp.join(root, f"config_{mode}.json")
        with open(cfg, "w") as f:
            json.dump(config, f)
        paths[mode] = osp.join(root, mode)
        proc = _cli("dpft_tpu_torch.prepare", src, cfg, paths[mode],
                    "--device", "cpu")
        assert proc.returncode == 0, proc.stderr
    got, want = paths["native"], paths["cpu"]
    assert _tree(got) == _tree(want)
    for split, sample in SAMPLES:
        a, b = (osp.join(r, split, "10", sample) for r in (got, want))
        for name in EXACT_ARRAYS + IMAGES:
            with open(osp.join(a, name), "rb") as fa, \
                    open(osp.join(b, name), "rb") as fb:
                assert fa.read() == fb.read(), name
        for name in PLANES:
            x, y = np.load(osp.join(a, name)), np.load(osp.join(b, name))
            assert x.shape == y.shape and x.dtype == y.dtype, name
            np.testing.assert_allclose(x, y, **TOL, err_msg=name)
