"""Gradients of the port's MSDA sampling core against the JAX package's.

The gradients of dpft_tpu_torch/ops/deform_attn.py:ms_deform_attn_core_plain
(the plain PyTorch version of the CUDA kernels csrc/msda_fwd.cu and
csrc/msda_bwd.cu), taken by PyTorch autograd, are held against jax.vjp of
the production JAX core (matmul levels plus a (1, 601) level on the gather
branch) and of the TPU kernel ms_deform_attn_pallas in interpret mode,
whose custom VJP is the one the CUDA backward replaces. Inputs come from a
numpy seed; locations are continuous and straddle the border, so the
zero-padding branch is hit and no point sits on an integer pixel (where
the matmul levels have kinks). Tolerance 1e-4 (relative and absolute):
float32 sums in another order. The CUDA backward itself runs only on the
card, where chip_smoke.py holds it against these gradients.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpft_tpu.ops.deform_attn import ms_deform_attn_core as jax_core
from dpft_tpu.ops.pallas.deform_attn import ms_deform_attn_pallas
from dpft_tpu_torch.ops import deform_attn as port

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SHAPES = ((6, 9), (3, 5), (2, 3), (1, 601))
TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(D, B=2, N=7, H=4, P=4, seed=0):
    rng = np.random.default_rng(seed)
    L = len(SHAPES)
    Len = sum(h * w for h, w in SHAPES)
    value = rng.normal(size=(B, Len, H, D)).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, size=(B, N, H, L, P, 2)).astype(np.float32)
    att = rng.uniform(size=(B, N, H, L, P)).astype(np.float32)
    att /= att.reshape(B, N, H, -1).sum(-1).reshape(B, N, H, 1, 1)
    grad = rng.normal(size=(B, N, H * D)).astype(np.float32)
    return value, loc, att, grad


def _port_grads(core, value, loc, att, grad):
    args = [torch.from_numpy(a).requires_grad_(True)
            for a in (value, loc, att)]
    out = core(args[0], SHAPES, args[1], args[2])
    out.backward(torch.from_numpy(grad))
    return [a.grad.numpy() for a in args]


def _jax_grads(fn, value, loc, att, grad):
    _, vjp = jax.vjp(lambda v, l, a: fn(v, SHAPES, l, a),
                     *map(jnp.asarray, (value, loc, att)))
    return [np.asarray(g) for g in vjp(jnp.asarray(grad))]


def _pallas(v, shapes, l, a):
    return ms_deform_attn_pallas(v, shapes, l, a, True)


@pytest.mark.parametrize("reference", ["jax_core", "pallas_interpret"])
@pytest.mark.parametrize("D", [2, 3])
def test_plain_gradients_match_jax(reference, D):
    fn = jax_core if reference == "jax_core" else _pallas
    inputs = _inputs(D, seed=D)
    got = _port_grads(port.ms_deform_attn_core_plain, *inputs)
    want = _jax_grads(fn, *inputs)
    for name, g, w in zip(("d_value", "d_loc", "d_att"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
    # The border cases are really there: some points add nothing.
    assert (got[2] == 0).any() and (got[2] != 0).any()


def test_far_out_points_get_zero_gradients():
    """Offsets are unbounded; a point whose corners all lie outside the map
    (as the CUDA backward skips it) gets no location or attention gradient
    and adds nothing to d_value."""
    value, loc, att, grad = _inputs(2, seed=7)
    loc[:, :3] = 1e6
    loc[:, 3:5] = -1e6
    d_value, d_loc, d_att = _port_grads(port.ms_deform_attn_core_plain,
                                        value, loc, att, grad)
    assert np.all(d_loc[:, :5] == 0) and np.all(d_att[:, :5] == 0)
    assert np.all(np.isfinite(d_value))


def test_core_takes_plain_path_under_autograd_on_cpu():
    inputs = _inputs(3, seed=11)
    before = (port.msda_fwd.launches, port.msda_bwd.launches)
    got = _port_grads(port.ms_deform_attn_core, *inputs)
    want = _port_grads(port.ms_deform_attn_core_plain, *inputs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (port.msda_fwd.launches, port.msda_bwd.launches) == before
