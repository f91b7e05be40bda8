"""The port's set loss against the JAX package's.

dpft_tpu_torch/training/loss.py is held against dpft_tpu/training/loss.py
on the same numpy predictions and padded targets, in float32, within 1e-5
(relative and absolute; sums in another order): the focal loss, the total
and every term with and without given indices, a sample without real
targets (exactly 0), a padded sample (``sample_mask``), the 'sum'
reduction, the no-assigner mode with its plain losses and GIoULoss, and
the gradient of the total with respect to the predictions against
jax.grad.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpft_tpu.training import loss as jloss
from dpft_tpu_torch.training import loss as port
from test_torch_port_matching import _outputs_targets, _torch

TOL = dict(rtol=1e-5, atol=1e-5)
WEIGHTS = {"total_class": 1.0, "object_class": 0.7, "center": 1.0,
           "size": 0.5, "angle": 2.0}


def test_focal_loss_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(scale=3.0, size=(64, 3)).astype(np.float32)
    t = rng.integers(0, 2, (64, 3)).astype(np.float32)
    got = port.focal_loss(torch.from_numpy(x), torch.from_numpy(t))
    want = jloss.focal_loss(jnp.asarray(x), jnp.asarray(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _case(seed, sample_mask):
    outputs, targets = _outputs_targets(np.random.default_rng(seed))
    if sample_mask:
        targets["sample_mask"] = np.array([True, False, True])
    return outputs, targets


def _compare(jl, pl, outputs, targets, use_indices):
    jfn = jax.jit(lambda o, t, i: jl(o, t, indices=i))
    indices = None
    if use_indices:
        jt = {k: v for k, v in targets.items() if k != "sample_mask"}
        indices = jax.jit(jl.match)(outputs, jt)
    (want_total, want_terms), want_grad = jax.value_and_grad(
        lambda o: jfn(o, targets, indices), has_aux=True)(outputs)

    out_t = {k: v.requires_grad_(True) for k, v in _torch(outputs).items()}
    port_indices = None if indices is None else tuple(
        torch.from_numpy(np.asarray(i, np.int64)) for i in indices)
    total, terms = pl(out_t, _torch(targets), indices=port_indices)
    total.backward()
    np.testing.assert_allclose(total.item(), float(want_total), **TOL)
    assert set(terms) == set(want_terms)
    for k in terms:
        np.testing.assert_allclose(terms[k].detach().numpy(),
                                   np.asarray(want_terms[k]), err_msg=k,
                                   **TOL)
    for k in outputs:
        grad = out_t[k].grad  # None where the loss does not read the output
        grad = torch.zeros_like(out_t[k]) if grad is None else grad
        np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad[k]),
                                   err_msg=k, **TOL)
    return total.item()


@pytest.mark.parametrize("use_indices", [True, False])
@pytest.mark.parametrize("sample_mask", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_loss_and_gradient_match_jax(use_indices, sample_mask, reduction):
    outputs, targets = _case(1, sample_mask)
    total = _compare(jloss.Loss(WEIGHTS, reduction=reduction),
                     port.Loss(WEIGHTS, reduction=reduction),
                     outputs, targets, use_indices)
    assert total > 0


def test_sample_without_targets_adds_exactly_zero():
    outputs, targets = _case(2, False)
    targets["gt_mask"][:] = False
    out = _torch(outputs)
    total, terms = port.Loss(WEIGHTS)(out, _torch(targets))
    assert total.item() == 0.0
    assert all(v.item() == 0.0 for v in terms.values())
    # One empty sample among real ones: its share is exactly 0.
    _, targets = _case(2, False)  # sample 2 has no real target
    per = port.Loss(WEIGHTS, reduction="none")(out, _torch(targets))[0]
    assert per[2].item() == 0.0 and per[0].item() > 0


@pytest.mark.parametrize("seed", [3, 6])
def test_cost_dtype_bfloat16_matches_jax(seed):
    """A bfloat16 cost may pick other pairs than the float32 one (these
    seeds do); both packages pick the same."""
    outputs, targets = _case(seed, False)
    got = port.Loss(WEIGHTS, cost_dtype="bfloat16").match(
        _torch(outputs), _torch(targets))
    want = jax.jit(jloss.Loss(WEIGHTS, cost_dtype="bfloat16").match)(
        outputs, targets)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="cost_dtype"):
        port.Loss(WEIGHTS, cost_dtype="int8")


def _dense_case(seed):
    """N == M targets for the no-assigner mode."""
    rng = np.random.default_rng(seed)
    B, M = 2, 6
    outputs, targets = _outputs_targets(rng, B=B, N=M, M=M)
    targets["gt_mask"][1, 4:] = False
    return outputs, targets


@pytest.mark.parametrize("losses", [
    {"class": "FocalLoss", "center": "L1Loss", "size": "MSELoss"},
    {"box": "GIoULoss", "center": "L1Loss"},
])
def test_no_assigner_mode_matches_jax(losses):
    outputs, targets = _dense_case(4)
    inputs = {"box": ["center", "size", "angle"]}
    weights = {name: 1.0 + i for i, name in enumerate(losses)}
    kw = dict(loss_weights=weights, use_assigner=False, losses=losses,
              loss_inputs=inputs)
    if "box" in losses:
        # GIoULoss has no gradient (as in the reference): values only.
        want = jloss.Loss(**kw)(outputs, targets)
        got = port.Loss(**kw)(_torch(outputs), _torch(targets))
        np.testing.assert_allclose(got[0].item(), float(want[0]), **TOL)
        np.testing.assert_allclose(got[1]["box"].item(),
                                   float(want[1]["box"]), **TOL)
        return
    _compare(jloss.Loss(**kw), port.Loss(**kw), outputs, targets, False)


def test_loss_from_config():
    config = {"loss_weights": WEIGHTS, "anassigner": "HungarianAnassigner",
              "reduction": "sum", "cost_dtype": "bfloat16"}
    loss = port.Loss.from_config(config)
    assert loss.use_assigner and loss.reduction == "sum"
    assert loss.cost_dtype == torch.bfloat16
    assert not port.Loss.from_config({"loss_weights": WEIGHTS}).use_assigner
    with pytest.raises(ValueError, match="Unknown loss"):
        port.Loss(WEIGHTS, losses={"x": "HingeLoss"})
