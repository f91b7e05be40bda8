"""Benchmark of the port on one CUDA card: the flagship's inference latency
(default), its train step, or the prepare pipeline's throughput.

    python -m dpft_tpu_torch.bench

Counterpart of the root ``bench.py`` (the JAX package's): the same three
modes, the same environment variables and defaults, and the same last line
of standard output, one JSON object, e.g.

    {"metric": "inference_ms_per_frame", "value": ..., "unit": "ms",
     "vs_baseline": ..., "baseline_source": "...", ...}

``vs_baseline`` compares with the reference's estimated per-frame GPU
latency: the DPFT paper (arXiv:2404.03015) reports about 90 ms/frame on the
authors' GPU and the reference publishes no number, so it is an estimate,
labelled as such, as the JAX bench labels it.

Environment:
- ``BENCH_MODE``: ``inference`` (default), ``train`` or ``prepare``.
- ``BENCH_BATCH`` (4), ``BENCH_DTYPE`` (``bfloat16``; ``float32`` or empty
  selects float32), ``BENCH_REPS`` (100, or 20 in train), ``BENCH_WARMUP``
  (10).
- ``BENCH_FLOPS``: count the FLOPs (on by default for inference, opt-in
  with 1 for train). ``BENCH_NO_METRIC=1``: train without the per-step
  metric (the step of ``train.logging`` null).
- ``BENCH_PREPARE_DEVICE``: the ``computing.prepare_device`` of the
  prepare run (``default``: the card's kernels, ``cpu``, ``native``);
  ``BENCH_PREPARE_WORKERS`` (2 for ``native``, else 1);
  ``BENCH_PREPARE_BASELINE`` (1: time the sequential baseline on one
  frame; 0: report it as not measured).
- Refused: ``BENCH_FLAT``, ``BENCH_HOIST`` and ``BENCH_FWD_ONCE`` set to 1
  select XLA step structures that the port leaves out on purpose (ROADMAP
  Queue 1 item 6): the bench prints the error line and exits 1.

Method:
- The flagship is ``config/kradar.json`` with the port's initialisation
  from a ``torch.Generator`` seeded 0, on the inputs of
  ``utils/example.py`` at camera 512x910, BEV 256x107 and front 37x107.
  Every mode turns TF32 off (``utils/device.py:use_full_float32``), as the
  CLIs do: float32 is the parity dtype. bfloat16 sets
  ``model.compute_dtype`` (autocast). Every output must be finite, or the
  bench exits 1.
- inference: the headline is ``profiling.benchmark_pipelined`` over 6
  distinct pre-staged batches (the example batch plus numpy noise of scale
  0.01 from seed 1), under ``torch.inference_mode``; the per-call mean and
  std come from ``profiling.benchmark`` (CUDA events per call). The FLOPs
  are the evaluator's count (``forward_flops``); the peak is
  ``torch.cuda.max_memory_allocated`` of the timed calls.
- train: one step is what the train CLI runs: ``CentralizedTrainer``'s
  ``train_step`` (forward, Hungarian matching on the host, loss, metric,
  backward) and the AdamW update. The host clock spans ``BENCH_REPS``
  steps that end in ``torch.cuda.synchronize``, after ``max(BENCH_WARMUP,
  2)`` steps. The FLOPs are ``profiling.cost_analysis`` of one whole step.
- prepare: a raw tree of the four frame ids of ``tests/kradar_fixture.py``
  at K-Radar's shapes (``utils/example.py:write_raw_kradar``, not timed),
  then the port's processor over it on the host clock.
- Every mode then runs ``profiling.device_activity`` over 3 calls (forward,
  step, or one frame's ``.mat`` read and radar planes): launches and
  device-busy ms per call, and the busy share, those ms over the call's
  time with tracing off (the headline's ms per batch, the step, the
  frame's read and planes). It runs after the timed calls: once the
  profiler has been used it stays attached and slows every later launch,
  so end-to-end numbers are taken with tracing off.
- ``mfu``: the achieved FLOP/s over ``peak_tflops``, the dense peak of the
  arithmetic the run uses on an H100 SXM at its 700 W limit
  (``PEAK_TFLOPS``).

``main`` runs on the card only: with no CUDA device it prints the error
line and exits 1, and nothing falls back to the CPU. The mode functions
take ``config`` and ``device`` so that tests can run them on the CPU at a
tiny size; such a result carries ``"device": "cpu"`` and null device
metrics. On standard error ``main`` also prints one ``bench:`` line with the
launches of every kernel wrapper over the whole run and the TF32 flags.
"""

from __future__ import annotations

import copy
import glob
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from dpft_tpu_torch.evaluation.evaluator import forward_flops, to_device
from dpft_tpu_torch.utils import profiling
from dpft_tpu_torch.utils.example import (KRADAR_CUBE, KRADAR_IMAGE_HW,
                                          SEQUENCE)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "config", "kradar.json")

REFERENCE_MS_PER_FRAME = 90.0  # estimate; see the module docstring
BASELINE_SOURCE = "paper arXiv:2404.03015 ~90 ms/frame (estimate)"
# Dense peaks of one NVIDIA H100 SXM at its 700 W power limit, NVIDIA's
# data sheet: float32 outside the tensor cores (TF32 off, the parity mode)
# and bfloat16 on them.
PEAK_TFLOPS = {"float32": 67.0, "bfloat16": 989.0}

MODES = {"inference": ("inference_ms_per_frame", "ms"),
         "train": ("train_sec_per_step", "s"),
         "prepare": ("prepare_gb_per_sec", "GB/s")}
# The root bench.py's XLA step structures (the config key each sets).
REFUSED = {"BENCH_FLAT": "train.flat_optimizer",
           "BENCH_HOIST": "train.hoist_matcher",
           "BENCH_FWD_ONCE": "train.forward_once"}
FLAGSHIP_HW = {"cam_hw": (512, 910), "bev_hw": (256, 107),
               "front_hw": (37, 107)}
# The frame ids of tests/kradar_fixture.py (sequence 10): two train frames,
# one val and one test frame of the frozen splits.
PREPARE_FRAMES = ("00027_00001", "00028_00002", "00039_00013", "00309_00283")
ARGSETS = 6         # distinct batches of the pipelined inference loop
ACTIVITY_CALLS = 3  # calls in the profiled window


class BenchError(RuntimeError):
    """A run whose result cannot stand: a non-finite output, a missing
    frame."""


def power_limit_w(index: int = 0) -> Optional[float]:
    """The card's power limit in W, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints it; None where nvidia-smi
    does not answer."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout
        return float(out.splitlines()[index].rsplit(",", 1)[1].split()[0])
    except (OSError, subprocess.CalledProcessError, IndexError, ValueError):
        return None


def _card(device: torch.device) -> Dict[str, Any]:
    if device.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    return {"device": torch.cuda.get_device_name(device),
            "power_limit_w": power_limit_w(device.index or 0)}


def _activity(fn: Callable[[], Any], device: torch.device,
              ms_per_call: float) -> Dict[str, Optional[float]]:
    """Launches and device ms per call of ``fn`` from one profiled window,
    and the busy share: those device ms over ``ms_per_call``, the call's
    time measured with tracing off."""
    if device.type != "cuda":
        return dict.fromkeys(("launches_per_call", "device_busy_share",
                              "device_ms_per_call"))
    act = profiling.device_activity(fn, reps=ACTIVITY_CALLS, device=device)
    return {"launches_per_call": act.launches,
            "device_busy_share": act.busy_ms / ms_per_call,
            "device_ms_per_call": act.busy_ms}


def _peak_gib(device: torch.device) -> Optional[float]:
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def _reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _drain(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rates(flops: Optional[float], seconds: float, dtype: str,
           device: torch.device) -> Dict[str, Optional[float]]:
    """achieved_tflops, mfu and peak_tflops: of the card only."""
    if flops is None or device.type != "cuda":
        return dict.fromkeys(("achieved_tflops", "mfu", "peak_tflops"))
    achieved = flops / seconds / 1e12
    return {"achieved_tflops": achieved, "mfu": achieved / PEAK_TFLOPS[dtype],
            "peak_tflops": PEAK_TFLOPS[dtype]}


def _check_finite(tensors, what: str) -> None:
    if not all(bool(torch.isfinite(t).all()) for t in tensors):
        raise BenchError(f"non-finite {what}")


def _flagship(config: Dict[str, Any], device: torch.device,
              batch_size: int, dtype: str, hw: Dict[str, Tuple[int, int]]):
    """The flagship model from seed 0 and its example batch (host arrays).
    """
    from dpft_tpu_torch.models import registry
    from dpft_tpu_torch.utils.device import use_full_float32
    from dpft_tpu_torch.utils.example import example_batch

    use_full_float32()
    model = registry.build(config["model"]["name"], config, device=device,
                           seed=0)
    model.compute_dtype = getattr(torch, dtype)
    return model, example_batch(config, B=batch_size, **hw)


def bench_inference(config: Dict[str, Any], device, batch_size: int,
                    repetitions: int, warmup: int, compute_dtype: str,
                    flops: bool = True,
                    hw: Dict[str, Tuple[int, int]] = FLAGSHIP_HW
                    ) -> Dict[str, Any]:
    """ms per frame of the flagship forward, pipelined over distinct
    batches; the per-call mean and std; FLOPs, MFU and peak memory."""
    device = torch.device(device)
    dtype = compute_dtype or "float32"
    model, batch = _flagship(config, device, batch_size, dtype, hw)
    # The reference times one batch of its test loader, which batches at
    # train.batch_size = 4, so B=4 is the protocol-matched default.
    rng = np.random.default_rng(1)
    argsets = []
    for _ in range(ARGSETS):
        noisy = {k: (v + rng.normal(scale=0.01, size=v.shape).astype(v.dtype)
                     if np.issubdtype(v.dtype, np.floating) else v)
                 for k, v in batch.items()}
        argsets.append((to_device(noisy, device),))
    _reset_peak(device)
    with torch.inference_mode():
        ms_per_batch = profiling.benchmark_pipelined(
            model, argsets, device=device, repetitions=repetitions,
            warmup=warmup)
        percall_mean, percall_std = profiling.benchmark(
            model, *argsets[0], device=device,
            repetitions=max(repetitions // 5, 10), warmup=2)
        _check_finite(model(*argsets[0]).values(), "forward outputs")
    peak = _peak_gib(device)
    count = float(forward_flops(model, *argsets[0])) if flops else None
    ms_per_frame = ms_per_batch / batch_size
    clock = ("CUDA events" if device.type == "cuda"
             else "time.perf_counter (CPU)")
    result = {
        "metric": "inference_ms_per_frame",
        "value": ms_per_frame,
        "unit": "ms",
        "vs_baseline": REFERENCE_MS_PER_FRAME / ms_per_frame,
        "baseline_source": BASELINE_SOURCE,
        "batch": batch_size,
        "dtype": dtype,
        "timing_protocol": (
            f"pipelined: {ARGSETS} distinct pre-staged batches enqueued "
            f"back to back, one {clock} pair over {repetitions} calls; "
            f"per call: {clock} around each call, device drained"),
        "per_call_ms_per_batch": percall_mean,
        "per_call_std_ms": percall_std,
        "forward_flops": count,
        **_rates(count, ms_per_batch / 1e3, dtype, device),
        "peak_hbm_gb": peak,
        **_card(device),
    }
    with torch.inference_mode():
        result.update(_activity(lambda: model(*argsets[0]), device,
                                ms_per_batch))
    return result


def bench_train(config: Dict[str, Any], device, batch_size: int,
                repetitions: int, warmup: int, compute_dtype: str,
                flops: bool = False, metric: bool = True,
                hw: Dict[str, Tuple[int, int]] = FLAGSHIP_HW
                ) -> Dict[str, Any]:
    """Seconds per train step of the flagship, as the train CLI runs it:
    forward, host matching, loss, metric, backward and the AdamW update."""
    from dpft_tpu_torch.evaluate import set_seed
    from dpft_tpu_torch.training.trainer import CentralizedTrainer
    from dpft_tpu_torch.utils.example import example_targets

    device = torch.device(device)
    dtype = compute_dtype or "float32"
    model, batch = _flagship(config, device, batch_size, dtype, hw)
    batch = to_device(batch, device)
    targets = to_device(example_targets(config, B=batch_size), device)
    set_seed(config["computing"]["seed"])  # dropout, as the CLI seeds it
    trainer = CentralizedTrainer.from_config(config)
    if not metric:
        trainer.metric = None
    optimizer = trainer.optimizer_factory(model.parameters())

    def step() -> Dict[str, float]:
        scalars = trainer.train_step(model, batch, targets)
        if scalars["loss"] > 0:  # the reference's update gate
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
        return scalars

    _reset_peak(device)
    for _ in range(max(warmup, 2)):
        step()
    _drain(device)
    t0 = time.perf_counter()
    for _ in range(repetitions):
        scalars = step()
    _drain(device)
    sec_per_step = (time.perf_counter() - t0) / repetitions
    peak = _peak_gib(device)
    if not all(map(math.isfinite, scalars.values())):
        raise BenchError(f"non-finite step scalars {scalars}")
    _check_finite(model.parameters(), "parameters after the steps")
    count = (float(profiling.cost_analysis(step)["flops"]) if flops
             else None)
    result = {
        "metric": "train_sec_per_step",
        "value": sec_per_step,
        "unit": "s",
        "vs_baseline": (REFERENCE_MS_PER_FRAME / 1e3 * batch_size)
        / sec_per_step,
        "baseline_source": (BASELINE_SOURCE + "; train baseline "
                            "unpublished, inference estimate used as floor"),
        "batch": batch_size,
        "dtype": dtype,
        "frames_per_sec": batch_size / sec_per_step,
        "grad_step_flops": count,
        **_rates(count, sec_per_step, dtype, device),
        "peak_hbm_gb": peak,
        "flops_source": (
            "FlopCounterMode over one whole step (forward and backward: 2 x "
            "the multiply-adds of convolutions and matrix products, the "
            "dpft::msda_fwd / msda_bwd formulas); AdamW's elementwise "
            "update and the host matching not counted" if flops else
            "not measured (set BENCH_FLOPS=1)"),
        **_card(device),
    }
    result.update(_activity(step, device, sec_per_step * 1e3))
    return result


def bench_prepare(config: Dict[str, Any], device, compute_dtype: str,
                  prepare_device: str = "default",
                  workers: Optional[int] = None, baseline: bool = True,
                  cube_shape: Tuple[int, ...] = KRADAR_CUBE,
                  image_hw: Tuple[int, int] = KRADAR_IMAGE_HW
                  ) -> Dict[str, Any]:
    """End-to-end throughput of the port's prepare pipeline (``.mat`` read,
    radar planes on ``prepare_device``, camera JPEGs, point clouds, files)
    over a raw tree of ``PREPARE_FRAMES`` written at ``cube_shape`` /
    ``image_hw`` (not timed): frames/s and GB/s of raw input, the phase
    split of one frame, and the baseline, a sequential ``.mat`` read and
    the port's NumPy reduction (``reduce_tesseract_np``) of one frame timed
    on the bench's own host."""
    from dpft_tpu_torch.data import prepare as build_processor
    from dpft_tpu_torch.ops.radar_reduce import reduce_tesseract_np
    from dpft_tpu_torch.utils.device import use_full_float32
    from dpft_tpu_torch.utils.example import write_raw_kradar

    device = torch.device(device)
    use_full_float32()
    config = copy.deepcopy(config)
    config["computing"].update(prepare_device=prepare_device,
                               device=str(device))
    config["data"]["workers"] = (workers if workers is not None else
                                 2 if prepare_device == "native" else 1)
    root = tempfile.mkdtemp(prefix="bench_prepare_")
    try:
        src = write_raw_kradar(root, PREPARE_FRAMES, cube_shape=cube_shape,
                               image_hw=image_hw)
        raw_bytes = sum(os.path.getsize(os.path.join(d, f))
                        for d, _, files in os.walk(src) for f in files)
        proc = build_processor(config["dataset"], config)
        seq_dir = os.path.join(src, SEQUENCE, "radar_tesseract")
        first_mat = os.path.join(seq_dir, sorted(os.listdir(seq_dir))[0])
        proc.get_radar_data(first_mat)  # builds the kernels, warms up

        # One frame: the .mat read alone, then read + planes.
        t0 = time.perf_counter()
        proc.get_radar_tesseract(first_mat, cast=False)
        loadmat_sec = time.perf_counter() - t0
        t0 = time.perf_counter()
        proc.get_radar_data(first_mat)
        radar_sec = time.perf_counter() - t0

        dst = os.path.join(root, "processed")
        t0 = time.perf_counter()
        proc.prepare(src, dst)
        _drain(device)
        dt = time.perf_counter() - t0

        samples = sorted(glob.glob(os.path.join(dst, "*", SEQUENCE, "*")))
        if len(samples) != len(PREPARE_FRAMES):
            raise BenchError(f"prepared {len(samples)} of "
                             f"{len(PREPARE_FRAMES)} frames")
        for sample in samples:
            _check_finite([torch.from_numpy(np.load(os.path.join(
                sample, f"{plane}.npy"))) for plane in ("ra", "ea")],
                f"planes of {sample}")

        baseline_ms: Optional[float] = None
        baseline_source = "not measured (BENCH_PREPARE_BASELINE=0)"
        if baseline:
            t0 = time.perf_counter()
            reduce_tesseract_np(proc.get_radar_tesseract(first_mat))
            baseline_ms = (time.perf_counter() - t0) * 1e3
            baseline_source = ("sequential .mat read + the port's NumPy "
                               "reduction (reduce_tesseract_np) measured on "
                               "the bench's host (one frame)")
        activity = _activity(lambda: proc.get_radar_data(first_mat), device,
                             radar_sec * 1e3)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    n_frames = len(samples)
    frames_per_sec = n_frames / dt
    return {
        "metric": "prepare_gb_per_sec",
        "value": raw_bytes / dt / 1e9,
        "unit": "GB/s",
        "vs_baseline": (None if baseline_ms is None
                        else frames_per_sec * baseline_ms / 1e3),
        "baseline_source": baseline_source,
        "frames": n_frames,
        "frames_per_sec": frames_per_sec,
        "sec_per_frame": dt / n_frames,
        "raw_gb": raw_bytes / 1e9,
        "baseline_sec_per_frame": (None if baseline_ms is None
                                   else baseline_ms / 1e3),
        "dtype": compute_dtype or "float32",
        "prepare_device": prepare_device,
        "loadmat_sec_per_frame": loadmat_sec,
        "radar_reduce_sec_per_frame": radar_sec - loadmat_sec,
        **_card(device),
        **activity,
    }


def _kernel_launches() -> Dict[str, int]:
    from dpft_tpu_torch.ops import deform_attn as da
    from dpft_tpu_torch.ops import radar_reduce as rr

    wrappers = {**da.LAUNCH_COUNTED, **rr.LAUNCH_COUNTED}
    return {name: w.launches for name, w in wrappers.items()}


def _fail(mode: str, error: str) -> None:
    metric, unit = MODES.get(mode, MODES["inference"])
    print(json.dumps({"metric": metric, "value": None, "unit": unit,
                      "vs_baseline": None, "error": error}))
    raise SystemExit(1)


def main() -> None:
    mode = os.environ.get("BENCH_MODE", "inference")
    if mode not in MODES:
        _fail(mode, f"unknown BENCH_MODE {mode!r}; one of {sorted(MODES)}")
    for var, key in REFUSED.items():
        if os.environ.get(var, "0") == "1":
            _fail(mode, f"{var}=1 selects the XLA step structure {key}, "
                  "which the port leaves out on purpose (ROADMAP.md Queue 1 "
                  "item 6)")
    compute_dtype = os.environ.get("BENCH_DTYPE", "bfloat16")
    if compute_dtype == "float32":
        compute_dtype = ""
    if compute_dtype not in ("", "bfloat16"):
        _fail(mode, f"BENCH_DTYPE {compute_dtype!r}: bfloat16, float32 or "
              "empty")
    if not torch.cuda.is_available():
        _fail(mode, "no CUDA device")

    from dpft_tpu_torch.utils.config import load_config

    device = torch.device("cuda", 0)
    config = load_config(CONFIG)
    batch_size = int(os.environ.get("BENCH_BATCH", "4"))
    warmup = int(os.environ.get("BENCH_WARMUP", "10"))
    try:
        if mode == "train":
            result = bench_train(
                config, device, batch_size,
                int(os.environ.get("BENCH_REPS", "20")), warmup,
                compute_dtype, flops=os.environ.get("BENCH_FLOPS") == "1",
                metric=os.environ.get("BENCH_NO_METRIC", "0") != "1")
        elif mode == "prepare":
            workers = os.environ.get("BENCH_PREPARE_WORKERS")
            result = bench_prepare(
                config, device, compute_dtype,
                prepare_device=os.environ.get("BENCH_PREPARE_DEVICE",
                                              "default"),
                workers=None if workers is None else int(workers),
                baseline=os.environ.get("BENCH_PREPARE_BASELINE",
                                        "1") == "1")
        else:
            result = bench_inference(
                config, device, batch_size,
                int(os.environ.get("BENCH_REPS", "100")), warmup,
                compute_dtype,
                flops=os.environ.get("BENCH_FLOPS", "1") == "1")
    except BenchError as exc:
        _fail(mode, str(exc))
    print("bench: " + json.dumps({
        "kernel_launches": _kernel_launches(),
        "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                 "cudnn": torch.backends.cudnn.allow_tf32}}), file=sys.stderr)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
