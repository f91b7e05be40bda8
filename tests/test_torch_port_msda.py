"""The port's MSDA sampling core against the JAX package's.

dpft_tpu_torch/ops/deform_attn.py:ms_deform_attn_core_plain (the plain
PyTorch version of the CUDA kernel csrc/msda_fwd.cu) is held against the
per-element reference ms_deform_attn_core_naive, the TPU kernel
ms_deform_attn_pallas in interpret mode (as its own tests run it on the
CPU), and the production JAX core. Inputs come from a numpy seed and
straddle the border, so the zero-padding branch is hit; one level with
h + w > 600 takes the JAX core's gather branch. The CUDA kernel itself runs
only on the card, where chip_smoke.py holds it against the plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dpft_tpu.ops.deform_attn import (ms_deform_attn_core,
                                      ms_deform_attn_core_naive)
from dpft_tpu.ops.pallas.deform_attn import ms_deform_attn_pallas
from dpft_tpu_torch.ops import deform_attn as port
from dpft_tpu_torch.ops import kernels

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SHAPES = ((6, 9), (3, 5), (2, 3), (1, 601))


def _inputs(D, B=2, N=7, H=4, P=4, shapes=SHAPES, seed=0):
    rng = np.random.default_rng(seed)
    L = len(shapes)
    Len = sum(h * w for h, w in shapes)
    value = rng.normal(size=(B, Len, H, D)).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, size=(B, N, H, L, P, 2)).astype(np.float32)
    att = rng.uniform(size=(B, N, H, L, P)).astype(np.float32)
    att /= att.reshape(B, N, H, -1).sum(-1).reshape(B, N, H, 1, 1)
    return value, loc, att


def _plain(value, loc, att, shapes=SHAPES, dtype=torch.float32):
    out = port.ms_deform_attn_core_plain(
        torch.from_numpy(value).to(dtype), shapes, torch.from_numpy(loc),
        torch.from_numpy(att).to(dtype))
    return out.float().numpy()


@pytest.mark.parametrize("D", [2, 3])
def test_plain_matches_naive_reference(D):
    value, loc, att = _inputs(D)
    want = np.asarray(ms_deform_attn_core_naive(value, SHAPES, loc, att))
    np.testing.assert_allclose(_plain(value, loc, att), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("D", [2, 3])
def test_plain_matches_pallas_kernel_interpret(D):
    value, loc, att = _inputs(D, seed=1)
    want = ms_deform_attn_pallas(jnp.asarray(value), SHAPES,
                                 jnp.asarray(loc), jnp.asarray(att), True)
    np.testing.assert_allclose(_plain(value, loc, att), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("D", [2, 3])
def test_plain_matches_jax_core(D):
    value, loc, att = _inputs(D, seed=2)
    want = ms_deform_attn_core(jnp.asarray(value), SHAPES, jnp.asarray(loc),
                               jnp.asarray(att))
    np.testing.assert_allclose(_plain(value, loc, att), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("D", [2, 3])
def test_plain_bf16_matches_jax_bf16(D):
    """Both sum in bfloat16 with float32 coordinates; the bound covers
    bfloat16 rounding at other places."""
    value, loc, att = _inputs(D, seed=3)
    want = ms_deform_attn_core(jnp.asarray(value, jnp.bfloat16), SHAPES,
                               jnp.asarray(loc),
                               jnp.asarray(att, jnp.bfloat16))
    got = _plain(value, loc, att, dtype=torch.bfloat16)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_far_out_locations_give_zero():
    """Offsets are unbounded: points far outside every map add nothing."""
    value, _, att = _inputs(2, seed=4)
    for far in (1e9, -1e9):
        loc = np.full((2, 7, 4, len(SHAPES), 4, 2), far, np.float32)
        np.testing.assert_array_equal(_plain(value, loc, att), 0.0)


def test_core_dispatch_takes_plain_on_cpu():
    value, loc, att = _inputs(3, seed=5)
    args = (torch.from_numpy(value), SHAPES, torch.from_numpy(loc),
            torch.from_numpy(att))
    before = port.msda_fwd.launches
    torch.testing.assert_close(port.ms_deform_attn_core(*args),
                               port.ms_deform_attn_core_plain(*args),
                               rtol=0, atol=0)
    assert port.msda_fwd.launches == before


def test_kernel_wrapper_refuses_cpu_tensors_and_grad():
    """No fallback: the kernel wrappers raise on CPU tensors instead of
    computing, also for inputs that require grad."""
    value, loc, att = _inputs(2, seed=6)
    args = [torch.from_numpy(value), SHAPES, torch.from_numpy(loc),
            torch.from_numpy(att)]
    with pytest.raises(RuntimeError, match="CUDA"):
        port.msda_fwd(*args)
    grad_out = torch.zeros(2, 7, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.msda_bwd(*args, grad_out)
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.msda_fwd(*args)


def test_kernel_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.nvcc_path()
