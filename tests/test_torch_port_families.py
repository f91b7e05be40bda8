"""Whole models of every backbone family, and the learnable querent,
against the JAX package.

The tiny config of test_full_model_parity with all three views' backbones
swapped (``chip_smoke.family_config``: the necks, embeddings and fuser
levels follow the family's two first stages): ConvNeXt-T with the
learnable querent in place of the static one, Swin-T and RegNet-Y-400MF.
Each is built in both packages on one set of random JAX variables carried
across by ``state_dict_from_flax``, and its eval forward is held against
JAX's on make_batch_4x's inputs (every side a multiple of 32, where the
JAX package's "SAME"-padded patchify convs agree with torchvision's, see
test_torch_port_backbone_convnext.py) within rtol 1e-4 / atol 2e-4 (the
bound of test_torch_port_model.py), float32, TF32 off, one thread. The
JAX package's Swin builds its shift masks with numpy, so its forward is
traced with what depends on no traced value evaluated on the spot
(``jax.ensure_compile_time_eval``). One train step of each:
test_torch_port_families_train.py.

The evaluator's FLOP count of each equals the reckoning by forward hooks.
And the learnable querent alone: its parameter is the reference's
``querent.queries``, its init lies within [minimum, maximum] from the
generator's seed, and it gives JAX's ``LearnableQueries`` output.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import family_config, reckon_flops
from dpft_tpu.models import build as jbuild
from dpft_tpu.models.queries import build_querent as jquerent
from dpft_tpu_torch.evaluation.evaluator import forward_flops
from dpft_tpu_torch.models import registry
from dpft_tpu_torch.models.convert import state_dict_from_flax
from dpft_tpu_torch.models.queries import LearnableQueries, build_querent
from test_full_model_parity import tiny_config
from test_torch_port_train import TRAIN, _torch, make_batch_4x
from torch_port_common import random_variables

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-4, atol=2e-4)
KEYS = ("class", "center", "size", "angle")
FAMILIES = [("ConvNeXt_Tiny", True), ("Swin_T", False),
            ("RegNet_Y_400MF", False)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config(backbone, learnable):
    config = family_config(tiny_config(), backbone, learnable=learnable,
                           multi_scale=2)
    config["train"] = dict(TRAIN)
    return config


@pytest.mark.parametrize("backbone,learnable", FAMILIES)
def test_forward_matches_jax(backbone, learnable):
    config = _config(backbone, learnable)
    batch = make_batch_4x(np.random.default_rng(0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = jbuild("dprt", config)
    variables = random_variables(jmodel, jbatch, train=False, seed=1,
                                 numpy_constants=backbone == "Swin_T")
    with jax.ensure_compile_time_eval():
        want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
            variables, jbatch)
    model = registry.build("dprt", config, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables, config),
                          strict=True)
    assert ("querent.queries" in model.state_dict()) == learnable
    with torch.inference_mode():
        got = model(_torch(batch))
    for key in KEYS:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **TOL)


@pytest.mark.parametrize("backbone,learnable", FAMILIES)
def test_flop_count_equals_reckoning(backbone, learnable):
    """The evaluator's count of a family model's forward equals the
    reckoning by forward hooks (``chip_smoke.reckon_flops``: Swin's window
    products over the padded windows among them), exactly."""
    model = registry.build("dprt", _config(backbone, learnable),
                           device="cpu")
    batch = _torch(make_batch_4x(np.random.default_rng(3)))
    assert forward_flops(model, batch) == reckon_flops(model, batch)


def test_learnable_querent_matches_jax():
    cfg = {"n_queries": 7, "minimum": [4, -50, 0], "maximum": [72, 50, 1]}
    port = build_querent("learnable_query", cfg)
    assert isinstance(port, LearnableQueries)
    assert list(port.state_dict()) == ["queries"]
    port.reset_parameters_seeded(torch.Generator().manual_seed(3))
    q = port.queries.detach()
    assert q.shape == (7, 3)
    assert (q >= torch.tensor(cfg["minimum"])).all() and \
        (q <= torch.tensor(cfg["maximum"])).all()
    again = build_querent("learnable_query", cfg)
    again.reset_parameters_seeded(torch.Generator().manual_seed(3))
    torch.testing.assert_close(again.queries, port.queries, rtol=0, atol=0)

    jmod = jquerent("learnable_query", cfg)
    query = np.random.default_rng(0).uniform(-3, 3, (7, 3)).astype(
        np.float32)
    want = jmod.apply({"params": {"query": jnp.asarray(query)}}, 2)
    state = state_dict_from_flax({"params": {"querent": {"query": query}}},
                                 {"model": {}})
    assert list(state) == ["querent.queries"]
    port.load_state_dict({"queries": state["querent.queries"]})
    got = port(2, torch.device("cpu"))["center"]
    np.testing.assert_array_equal(got.detach().numpy(),
                                  np.asarray(want["center"]))
