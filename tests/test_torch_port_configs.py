"""The four other shipped configs against the JAX package: the modality
ablations ``kradar_camera_mono.json`` (one view), ``kradar_radar.json``
(two), ``kradar_radar_bev.json`` and ``kradar_radar_front.json`` (one
each), so the fuser runs at ``m_views`` 1 and 2.

Each config is cut as tests/test_models.py cuts it (ResNet18 backbones
without pretrained weights, the necks' input widths set to ResNet18's,
``i_iter`` 2) and to 16 queries (a 4 x 4 querent grid), and built in both
packages; the JAX variables (random, seed 1) go into the port through
``state_dict_from_flax``, and both forwards run the same numpy batch of the
config's views in float32 with TF32 off, within rtol 1e-4 / atol 2e-4 (the
bound of test_torch_port_model.py). The float64 train step of each config
is held in test_torch_port_configs_train.py.

For ``kradar_camera_mono.json`` and ``kradar_radar_bev.json`` the
dataset's modality selection (``data.camera`` / ``data.radar``) runs on
the fixture tree: the port's dataset gives the JAX package's keys and
arrays, and only the views of the config's ``model.inputs``.
"""

import copy
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dpft_tpu.data as jax_data
import dpft_tpu_torch.data as port_data
from dpft_tpu.models import build as jbuild
from dpft_tpu_torch.models import registry
from dpft_tpu_torch.models.convert import state_dict_from_flax
from dpft_tpu_torch.utils.config import load_config
from kradar_fixture import base_config, make_raw_kradar
from test_full_model_parity import make_batch
from torch_port_common import assert_trees_equal, random_variables

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIGS = ["kradar_camera_mono.json", "kradar_radar.json",
           "kradar_radar_bev.json", "kradar_radar_front.json"]
TOL = dict(rtol=1e-4, atol=2e-4)
VIEWS = {"camera_mono", "radar_bev", "radar_front"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cut_config(name, dropout=None):
    """``config/<name>`` cut to test size (see the module docstring)."""
    config = load_config(osp.join(ROOT, "config", name))
    config["computing"] = {"seed": 0}
    model = config["model"]
    for backbone in model["backbones"].values():
        backbone["name"] = "ResNet18"
        backbone["weights"] = ""
    for neck in model["necks"].values():
        neck["in_channels_list"] = [neck["in_channels_list"][0], 64, 128,
                                    256, 512]
    model["fuser"]["i_iter"] = 2
    model["fuser"]["n_queries"] = 16
    model["querent"]["resolution"] = [4, 4, 1]
    if dropout is not None:
        model["fuser"]["dropout"] = dropout
    return config


def view_batch(config, batch):
    """The keys of ``batch`` that belong to the config's views."""
    inputs = config["model"]["inputs"]
    return {k: v for k, v in batch.items()
            if any(k == n or k.startswith(f"{n}_") or k.endswith(f"_{n}_t")
                   or k.endswith(f"_{n}_p") for n in inputs)}


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_jax(name):
    config = cut_config(name)
    m_views = len(config["model"]["inputs"])
    assert config["model"]["fuser"]["m_views"] == m_views
    batch_np = view_batch(config, make_batch(np.random.default_rng(0)))
    jmodel = jbuild("dprt", config)
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    variables = random_variables(jmodel, batch, train=False, seed=1)
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        variables, batch)
    model = registry.build("dprt", config, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables, config),
                          strict=True)
    with torch.inference_mode():
        got = model({k: torch.from_numpy(v) for k, v in batch_np.items()})
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == (2, 16, want[k].shape[-1]), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **TOL, err_msg=k)


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    """The fixture tree, prepared by the port's ETL on its NumPy path."""
    root = str(tmp_path_factory.mktemp("configs_data"))
    config = base_config()
    config["data"]["use_device"] = False
    dst = osp.join(root, "processed")
    port_data.prepare("kradar", config).prepare(make_raw_kradar(root), dst)
    return dst


@pytest.mark.parametrize("name", ["kradar_camera_mono.json",
                                  "kradar_radar_bev.json"])
def test_dataset_selects_the_config_views(processed, name):
    shipped = load_config(osp.join(ROOT, "config", name))
    config = base_config()
    config["data"].update({k: shipped["data"][k] for k in ("camera", "radar")
                           if k in shipped["data"]})
    inputs = set(shipped["model"]["inputs"])
    for split in ("train", "test"):
        got = port_data.init("kradar", src=processed, split=split,
                             config=copy.deepcopy(config))
        want = jax_data.init("kradar", src=processed, split=split,
                             config=copy.deepcopy(config))
        assert len(got) == len(want) > 0
        for i in range(len(want)):
            (g_in, g_tgt), (w_in, w_tgt) = got[i], want[i]
            assert_trees_equal(g_in, w_in, f"{name} {split}[{i}] inputs")
            assert_trees_equal(g_tgt, w_tgt, f"{name} {split}[{i}] targets")
            assert {v for v in VIEWS if v in g_in} == inputs
            assert not any(k.startswith(f"{v}") or k.endswith(f"_{v}_t")
                           for k in g_in for v in VIEWS - inputs)
