"""The port's measuring module against the JAX package's.

``dpft_tpu_torch/utils/profiling.py`` is the counterpart of
``dpft_tpu/utils/profiling.py``. On the CPU its timing functions read
``time.perf_counter`` (on the card, CUDA events, which only the card can
run). Here a scripted clock drives both modules' arithmetic: the port's
``benchmark`` gives the mean and the sample std (ddof=1), equal to the JAX
function's on the same recorded times (the JAX readback round trip
scripted to 0 ms, which it subtracts). The evaluator's latency
goes through ``benchmark``: its std is the JAX package's, where it used to
be numpy's ddof=0 std. ``parameter_count`` of the tiny model equals JAX's
on the flax tree of the same weights; ``cost_analysis`` equals the
evaluator's ``forward_flops``; ``trace`` writes a Chrome trace;
``device_activity`` refuses the CPU, and its interval union and kernel
names are held on spans and names of the card's kind.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dpft_tpu.models import build as jbuild
from dpft_tpu.utils import profiling as jax_profiling
from dpft_tpu_torch.evaluation import evaluator as evaluator_module
from dpft_tpu_torch.evaluation.evaluator import (CentralizedEvaluator,
                                                 forward_flops)
from dpft_tpu_torch.models import dpft as dpft_module
from dpft_tpu_torch.models import registry
from dpft_tpu_torch.models.convert import state_dict_from_flax
from dpft_tpu_torch.utils import profiling
from test_full_model_parity import make_batch, tiny_config
from torch_port_common import random_variables

# Per-call durations in seconds, irregular enough that the two stds differ.
DURATIONS = (0.0123, 0.0131, 0.0119, 0.0302, 0.0127, 0.0125, 0.0188)


class ScriptedClock:
    """Stands in for the ``time`` module: ``perf_counter`` returns the
    scripted readings in order and fails if one is read too many."""

    def __init__(self, readings):
        self.readings = list(readings)

    def perf_counter(self):
        assert self.readings, "the clock was read more often than scripted"
        return self.readings.pop(0)


def _pairs(durations, start=100.0):
    """(start, stop) readings of calls that took ``durations`` s."""
    readings, t = [], start
    for d in durations:
        readings += [t, t + d]
        t += 1.0
    return readings


RTT_ZERO = [5.0] * 10  # JAX's readback_rtt_ms: five empty round trips


class Calls:
    """A function that counts its calls."""

    def __init__(self, fn=lambda x: x):
        self.n = 0
        self.fn = fn

    def __call__(self, *args):
        self.n += 1
        return self.fn(*args)


def test_benchmark_is_the_jax_arithmetic(monkeypatch):
    reps = len(DURATIONS)
    port_clock = ScriptedClock(_pairs(DURATIONS))
    monkeypatch.setattr(profiling, "time", port_clock)
    fn = Calls()
    mean, std = profiling.benchmark(fn, torch.ones(3), device="cpu",
                                    repetitions=reps, warmup=3)
    assert fn.n == 3 + reps and not port_clock.readings

    monkeypatch.setattr(jax_profiling, "time",
                        ScriptedClock(RTT_ZERO + _pairs(DURATIONS)))
    want = jax_profiling.benchmark(jnp.sin, jnp.ones(3), repetitions=reps,
                                   warmup=3)
    assert (mean, std) == want
    times = np.array([(b - a) * 1e3 for a, b in
                      zip(*[iter(_pairs(DURATIONS))] * 2)])
    assert std == np.std(times, ddof=1) != np.std(times)


class _Scale(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(3))

    def forward(self, batch):
        return {"out": batch["x"] * self.w}


def test_evaluator_latency_std_is_the_jax_packages(monkeypatch):
    """The evaluator's latency is ``profiling.benchmark``'s: mean and the
    ddof=1 std, equal to JAX's ``benchmark`` on the same recorded times,
    where the evaluator used to report numpy's ddof=0 std."""
    reps, warmup = len(DURATIONS), 2
    loader = [({"x": np.ones((1, 3), np.float32)}, {})]
    evaluator = CentralizedEvaluator(repetitions=reps, warmup=warmup)
    assert evaluator.evaluate_inference_time(_Scale(), loader) == {}

    monkeypatch.setattr(evaluator_module, "LATENCY_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(profiling, "time", ScriptedClock(_pairs(DURATIONS)))
    got = evaluator.evaluate_inference_time(_Scale(), loader)

    monkeypatch.setattr(jax_profiling, "time",
                        ScriptedClock(RTT_ZERO + _pairs(DURATIONS)))
    mean, std = jax_profiling.benchmark(jnp.sin, jnp.ones(3),
                                        repetitions=reps, warmup=warmup)
    assert got == {"Inference_time_mean_ms": mean,
                   "Inference_time_std_ms": std}
    times = [(b - a) * 1e3 for a, b in zip(*[iter(_pairs(DURATIONS))] * 2)]
    old = float(np.std(times))  # the evaluator's value before
    assert got["Inference_time_std_ms"] != old
    assert got["Inference_time_mean_ms"] == float(np.mean(times))


@pytest.fixture(scope="module")
def tiny():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    config = tiny_config()
    jmodel = jbuild("dprt", config)
    batch_np = make_batch(np.random.default_rng(0))
    variables = random_variables(
        jmodel, {k: jnp.asarray(v) for k, v in batch_np.items()},
        train=False, seed=1)
    model = registry.build("dprt", config, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables, config),
                          strict=True)
    batch = {k: torch.as_tensor(v, dtype=torch.float32)
             for k, v in batch_np.items()}
    yield model, variables, batch
    torch.set_num_threads(before)


def test_parameter_count_equals_jax(tiny):
    model, variables, _ = tiny
    want = jax_profiling.parameter_count(variables["params"])
    assert profiling.parameter_count(model) == want
    assert dpft_module.parameter_count is profiling.parameter_count


def test_cost_analysis_equals_forward_flops(tiny):
    model, _, batch = tiny
    flops = forward_flops(model, batch)
    assert flops > 0
    # With gradients on (the parameters' views then have autograd nodes,
    # which the counter's module tracker needs): the forward alone counts.
    assert profiling.cost_analysis(model, batch) == {"flops": flops}


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir, "cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(log_dir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_device_activity_counts_the_card_only():
    with pytest.raises(ValueError, match="CUDA"):
        profiling.device_activity(lambda: None, device="cpu")


def test_busy_time_counts_overlap_once():
    # Two streams at once: [0, 10) and [5, 12) overlap; [20, 21) apart;
    # [1, 3) lies inside the first.
    spans = [(20.0, 21.0), (5.0, 12.0), (0.0, 10.0), (1.0, 3.0)]
    assert profiling.busy_time(spans) == 13.0
    assert profiling.busy_time([]) == 0.0


@pytest.mark.parametrize("name, short", [
    ("void (anonymous namespace)::msda_fwd_kernel<float, 2>(float const*, "
     "int)", "msda_fwd_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float>>(int, float)", "vectorized_elementwise_kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
    ("Memset (Device)", "Memset"),
])
def test_kernel_names(name, short):
    assert profiling.kernel_name(name) == short
