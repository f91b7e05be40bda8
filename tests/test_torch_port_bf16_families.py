"""How far the bfloat16 forward of the ConvNeXt and RegNet models lies from
their float32 forward, in the port and in the JAX package, on the same
weights at init.

On the card, at the flagship shapes and the port's own init, the B=1 bf16
forward of ConvNeXt-T and RegNet-Y-400MF lay 0.297 and 0.287 of the
largest output from f32 (Swin-T 0.020). The two packages run bf16 by
different policies: the port under ``torch.autocast``, the JAX package by
a compute dtype threaded through every module. This test asks whether the
port's policy is at fault: the tiny config with every view's backbone
swapped (``chip_smoke.family_config``, all four stages, ConvNeXt-T with
the learnable querent), the port's seeded init carried into JAX by
``convert_full_model``, make_batch_4x's inputs at B=1, and per output the
largest |bf16 - f32| over the largest |f32|, on each side.

Measured on the CPU (when this test was written): ConvNeXt-T JAX 0.0045 /
0.9e-4 / 0.0091 / 0.022 (angle / center / class / size), port 0.0050 /
0.6e-4 / 0.011 / 0.020; RegNet-Y-400MF JAX 0.0079 / 0.5e-4 / 0.0058 /
0.0084, port 0.0074 / 0.4e-4 / 0.0066 / 0.0064; ResNet-50, for scale,
JAX 0.011 / 0.3e-4 / 0.0066 / 0.0077, port 0.0084 / 0.4e-4 / 0.0066 /
0.0075. Both packages part by the same order, so at these sizes the
port's autocast policy adds nothing that JAX's does not; the test holds
the port within twice JAX's distance (plus 1e-3) and both below 0.05, far
below the card's 0.29.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import family_config
from dpft_tpu.models import build as jbuild
from dpft_tpu.models.torch_checkpoint import convert_full_model
from dpft_tpu_torch.models import registry
from dpft_tpu_torch.models.convert import state_dict_from_flax
from test_full_model_parity import tiny_config
from test_torch_port_train import make_batch_4x

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _drift(f32, bf16):
    return {k: float(np.abs(bf16[k] - f32[k]).max() / np.abs(f32[k]).max())
            for k in f32}


@pytest.mark.parametrize("backbone,learnable", [("ConvNeXt_Tiny", True),
                                                ("RegNet_Y_400MF", False)])
def test_bf16_drift_is_the_family_not_the_port(backbone, learnable):
    config = family_config(tiny_config(), backbone, learnable=learnable,
                           multi_scale=4)
    batch = make_batch_4x(np.random.default_rng(0), B=1)
    state = registry.build("dprt", config, device="cpu",
                           seed=0).state_dict()
    variables = convert_full_model({k: v.numpy() for k, v in state.items()},
                                   config)
    out = {}
    for dtype in ("float32", "bfloat16"):
        c = copy.deepcopy(config)
        c["computing"]["compute_dtype"] = dtype
        jmodel = jbuild("dprt", c)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        out["jax", dtype] = {
            k: np.asarray(v, np.float32) for k, v in
            jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
                variables, jbatch).items()}
        model = registry.build("dprt", c, device="cpu")
        model.load_state_dict(state_dict_from_flax(variables, c),
                              strict=True)
        with torch.inference_mode():
            out["port", dtype] = {
                k: v.float().numpy() for k, v in
                model({k: torch.from_numpy(v) for k, v in
                       batch.items()}).items()}
    for k, v in out["jax", "float32"].items():  # the same function in f32
        np.testing.assert_allclose(out["port", "float32"][k], v,
                                   rtol=1e-4, atol=2e-4, err_msg=k)
    jax_drift = _drift(out["jax", "float32"], out["jax", "bfloat16"])
    port_drift = _drift(out["port", "float32"], out["port", "bfloat16"])
    for k, d in port_drift.items():
        assert d <= 2 * jax_drift[k] + 1e-3, (k, d, jax_drift[k])
        assert max(d, jax_drift[k]) < 0.05, (k, d, jax_drift[k])
