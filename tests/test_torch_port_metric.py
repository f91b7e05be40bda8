"""The port's detection metrics against the JAX package's.

dpft_tpu_torch/evaluation/metric.py (mAP3D, mGIoU3D and the endpoint-line
interp) is held against dpft_tpu/evaluation/metric.py on the same numpy
batches, in float32, within 1e-5: predictions near the targets (so some
pairs pass the 0.5 IoU threshold) and scattered ones, three classes (so
the lowest-present-class drop matters), padded targets, an empty sample
and a padded sample (``sample_mask``). The port's evaluator, with metrics
on, gives the JAX evaluator's values on the same checkpoint.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpft_tpu.evaluation.evaluator import CentralizedEvaluator as JEvaluator
from dpft_tpu.evaluation.metric import Metric as JMetric
from dpft_tpu.models import registry as jregistry
from dpft_tpu.utils.misc import interp as jinterp
from dpft_tpu_torch.evaluation import CentralizedEvaluator
from dpft_tpu_torch.evaluation import metric as port
from dpft_tpu_torch.models import registry
from test_full_model_parity import make_batch, tiny_config
from test_torch_port_model import _Loader, _targets

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-5, atol=1e-5)
METRICS = {"mAP": "mAP3D", "mGIoU": "mGIoU3D"}


def _batch(seed, B=4, N=30, M=8, C=3):
    rng = np.random.default_rng(seed)
    gang = rng.uniform(-np.pi, np.pi, (B, M))
    targets = {
        "gt_class": np.eye(C)[rng.integers(0, C, (B, M))],
        "gt_center": np.stack([rng.uniform(5, 60, (B, M)),
                               rng.uniform(-6, 6, (B, M)),
                               rng.uniform(-1, 1, (B, M))], -1),
        "gt_size": rng.uniform(1, 4, (B, M, 3)),
        "gt_angle": np.stack([np.sin(gang), np.cos(gang)], -1),
    }
    # The first M predictions sit near the targets, the rest anywhere.
    near = rng.integers(0, 2, (B, M)).astype(bool)
    center = np.concatenate([
        targets["gt_center"] + rng.normal(scale=0.3, size=(B, M, 3)),
        np.stack([rng.uniform(5, 60, (B, N - M)),
                  rng.uniform(-6, 6, (B, N - M)),
                  rng.uniform(-1, 1, (B, N - M))], -1)], 1)
    center[:, :M][~near] += 20.0
    ang = np.concatenate([gang + rng.normal(scale=0.1, size=(B, M)),
                          rng.uniform(-np.pi, np.pi, (B, N - M))], 1)
    outputs = {
        "class": rng.normal(size=(B, N, C)) + 2.0 * np.concatenate(
            [targets["gt_class"], np.zeros((B, N - M, C))], 1),
        "center": center,
        "size": np.concatenate([targets["gt_size"] * rng.uniform(
            0.8, 1.2, (B, M, 3)), rng.uniform(1, 4, (B, N - M, 3))], 1),
        "angle": np.stack([np.sin(ang), np.cos(ang)], -1),
    }
    outputs = {k: v.astype(np.float32) for k, v in outputs.items()}
    targets = {k: v.astype(np.float32) for k, v in targets.items()}
    targets["gt_mask"] = np.arange(M)[None].repeat(B, 0) < [[8], [5], [0],
                                                            [3]][:B]
    targets["sample_mask"] = np.array([True, True, True, False][:B])
    return outputs, targets


def _torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def test_interp_matches_jax():
    rng = np.random.default_rng(0)
    x = np.linspace(-0.2, 1.2, 33).astype(np.float32)
    xp = np.sort(rng.uniform(size=(3, 9)), 1).astype(np.float32)
    xp[2] = 0.5  # zero x-extent: 0 everywhere
    fp = rng.uniform(size=(3, 9)).astype(np.float32)
    got = port.interp(torch.from_numpy(x), torch.from_numpy(xp),
                      torch.from_numpy(fp), right=0.0).numpy()
    for i in range(3):
        want = jinterp(jnp.asarray(x), jnp.asarray(xp[i]), jnp.asarray(fp[i]),
                       right=0.0)
        np.testing.assert_allclose(got[i], np.asarray(want), **TOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("seed", [0, 1])
def test_metric_matches_jax(seed, reduction):
    outputs, targets = _batch(seed)
    got = port.Metric(METRICS, reduction)(_torch(outputs), _torch(targets))
    want = jax.jit(JMetric(METRICS, reduction))(outputs, targets)
    assert set(got) == set(want) == set(METRICS)
    for k in METRICS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    per = port.detection_metrics(_torch(outputs), _torch(targets))
    assert (per["mAP3D"][:3] > 0).any() and (per["mAP3D"][:3] < 1).any()
    assert per["mGIoU3D"][2] == 1.0  # no real target: one class present


def test_metric_without_sample_mask_and_config():
    outputs, targets = _batch(2)
    del targets["sample_mask"]
    metric = port.build_metric({"metrics": {"ap": "mAP3D"}})
    got = metric(_torch(outputs), _torch(targets))
    want = jax.jit(JMetric({"ap": "mAP3D"}))(outputs, targets)
    np.testing.assert_allclose(got["ap"].item(), float(want["ap"]), **TOL)
    assert port.Metric({})(_torch(outputs), _torch(targets)) == {}
    with pytest.raises(ValueError, match="Unknown metric"):
        port.Metric({"x": "mAP2D"})


def test_evaluator_metrics_match_jax_evaluator(tmp_path):
    config = tiny_config()
    config["data"] = {"num_classes": 2,
                      "categories": {"Sedan": 0, "Background": -1}}
    config["evaluate"] = {"metrics": dict(METRICS)}
    config["train"] = {"logging": None}
    model = registry.build("dprt", config, device="cpu", seed=13)
    ckpt = str(tmp_path / "run" / "2026-01-01-00-00-00_checkpoint_0004.pt")
    registry.save(model, config, ckpt)
    rng = np.random.default_rng(14)
    loader = _Loader([(make_batch(rng), _targets(config, s)) for s in (0, 1)])

    got = CentralizedEvaluator.from_config(config, device="cpu") \
        .evaluate_one_epoch(registry.load(ckpt, device="cpu")[0], loader)
    jmodel, variables, _, _ = jregistry.load(ckpt)
    fwd = jax.jit(lambda b: jmodel.apply(variables, b, train=False))
    want = JEvaluator.from_config(config).evaluate_one_epoch(0, fwd, loader)
    assert set(got) == set(want) == set(METRICS)
    for k in METRICS:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
