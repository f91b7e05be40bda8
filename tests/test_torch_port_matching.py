"""The port's Hungarian matching against the JAX package's.

dpft_tpu_torch/ops/hungarian.py:assign (host solve with native/lap.cc)
must give exactly the indices of dpft_tpu/ops/hungarian.py:assign (device
solve) on random float costs, which have a unique optimum: with and
without a row mask, and with every target padded. The matching cost of
dpft_tpu_torch/training/assigner.py agrees with the JAX cost_matrix within
1e-5 (relative; geometry in another order), and Loss.match picks the same
pairs as the JAX Loss.match.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpft_tpu.ops import hungarian as jhungarian
from dpft_tpu.training import assigner as jassigner
from dpft_tpu.training.loss import Loss as JLoss
from dpft_tpu_torch.ops import hungarian
from dpft_tpu_torch.training import assigner
from dpft_tpu_torch.training.loss import Loss

WEIGHTS = {"total_class": 1.0, "object_class": 0.0, "center": 1.0,
           "size": 1.0, "angle": 1.0}


def _jax_assign(cost, row_mask):
    if row_mask is None:
        return jax.vmap(jhungarian.assign)(jnp.asarray(cost))
    return jax.vmap(jhungarian.assign)(jnp.asarray(cost),
                                       jnp.asarray(row_mask))


@pytest.mark.parametrize("mask", ["none", "partial", "all_padded"])
def test_assign_matches_jax_exactly(mask):
    rng = np.random.default_rng(0)
    B, N, M = 3, 40, 8
    cost = rng.normal(size=(B, N, M)).astype(np.float32)
    row_mask = {"none": None,
                "partial": np.arange(M)[None].repeat(B, 0) < [[3], [8], [0]],
                "all_padded": np.zeros((B, M), bool)}[mask]
    got = hungarian.assign(torch.from_numpy(cost),
                           None if row_mask is None
                           else torch.from_numpy(row_mask))
    want = _jax_assign(cost, row_mask)
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    index_i = got[0].numpy()
    assert np.all(np.diff(index_i, axis=1) >= 0)  # ascending
    if mask == "all_padded":
        assert np.all(index_i == N)


def _outputs_targets(rng, B=3, N=24, M=6, C=2):
    ang = rng.uniform(-np.pi, np.pi, (B, N))
    outputs = {
        "class": rng.normal(size=(B, N, C)),
        "center": rng.uniform(0, 8, (B, N, 3)),
        "size": rng.uniform(0.5, 4, (B, N, 3)),
        "angle": np.stack([np.sin(ang), np.cos(ang)], -1),
    }
    gang = rng.uniform(-np.pi, np.pi, (B, M))
    targets = {
        "gt_class": np.eye(C)[rng.integers(0, C, (B, M))],
        "gt_center": rng.uniform(0, 8, (B, M, 3)),
        "gt_size": rng.uniform(1, 4, (B, M, 3)),
        "gt_angle": np.stack([np.sin(gang), np.cos(gang)], -1),
    }
    cast = {k: v.astype(np.float32) for k, v in {**outputs, **targets}.items()}
    cast["gt_mask"] = np.arange(M)[None].repeat(B, 0) < [[4], [6], [0]][:B]
    return ({k: cast[k] for k in outputs},
            {k: cast[k] for k in (*targets, "gt_mask")})


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def test_cost_matrix_matches_jax():
    outputs, targets = _outputs_targets(np.random.default_rng(1))
    got = assigner.cost_matrix(_torch(outputs), _torch(targets), WEIGHTS)
    want = jax.jit(jax.vmap(lambda o, t: jassigner.cost_matrix(
        o, t, WEIGHTS)))(outputs, targets)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert np.all(got.numpy()[2] == 1e6)  # a sample with every target padded


def test_loss_match_matches_jax():
    outputs, targets = _outputs_targets(np.random.default_rng(2))
    got = Loss(WEIGHTS).match(_torch(outputs), _torch(targets))
    want = jax.jit(JLoss(WEIGHTS).match)(outputs, targets)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
