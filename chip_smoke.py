"""Smoke test of the PyTorch port on one CUDA card (H100).

    python3 chip_smoke.py

Run from the root of the repository. It imports nothing of JAX. Phases,
each printed on its own lines; any failure raises and the exit code is
not 0:

1. Device: the card's name and power limit (nvidia-smi), the CUDA, nvcc
   and triton versions.
2. Build: the CUDA kernels from dpft_tpu_torch/csrc into build/kernels.
3. Kernel vs plain: ``msda_fwd`` against ``ms_deform_attn_core_plain`` on
   the card, at small shapes with border locations (D = 2, 3) and at the
   flagship level shapes of all three views (read from the built model),
   f32 within 1e-5 and bf16 within 2e-2; the time of both for one camera
   call.
4. Flagship forward: config/kradar.json built on the card from a seed, at
   production shapes (camera 512x910, BEV 256x107, front 37x107). At B=1
   f32 the model is held against the same model with the plain core
   (1e-4); outputs are finite and shaped; latency (CUDA events) and peak
   memory at B=1 and B=4 in f32 and bf16.
5. Serve path (the first main path): registry.save -> registry.load ->
   CentralizedEvaluator over two synthetic batches -> the K-Radar txt tree.
   The launch counts of both kernels are reset right before it and read
   right after: msda_fwd exactly once per MSDA call, msda_bwd never.
6. Backward kernel vs plain: ``msda_bwd`` against torch.autograd.grad
   through ``ms_deform_attn_core_plain`` on the same inputs and grad_out,
   at the small border cases (D = 2, 3) and at the flagship level shapes of
   all three views at B=4, N=400: f32 within 1e-4 (atomics add in a
   varying order), bf16 against the f32 plain gradient within 5e-2 of its
   largest element; the time of one camera-view backward of both.
7. Train step, kernel model vs plain-core model: config/kradar.json at
   B=4 f32, the same weights, batch and dropout seed; the loss within 1e-4
   (relative) and every parameter gradient within 1e-3 of its largest.
8. Train path (the second main path): CentralizedTrainer over 4 synthetic
   B=4 batches for 2 epochs with a 2-batch validation loader, metrics on;
   finite losses, changed parameters, validation metrics, one checkpoint
   per epoch, a resume from the epoch-0 checkpoint, and exact launch
   counts of both kernels (counts reset right before, read right after).
9. Train step time by CUDA events at B=4 in f32 and bf16 (mean of 10 steps
   after 3 warm-up steps), the host share of matching, peak memory.
10. Radar kernels vs plain: ``radar_reduce_ra`` / ``radar_reduce_ea``
   against ``reduce_tesseract_plain`` on the card at four small cubes and
   at K-Radar's (64, 256, 37, 107), positive powers from a numpy seed,
   rtol 3e-4 / atol 3e-2 (float32 sums in another order) channel by
   channel, each channel's typical value printed beside its error and
   required to lie above 30 times atol, with the doppler-of-max lookup
   channel exactly equal; beyond their shared-memory limits the wrappers
   raise; at full size also against
   the numpy transliteration on the host. Times by CUDA events: each
   kernel, the plain version, the copy of one cube to the card from
   pageable and from pinned memory, each beside its bound.
11. Prepare path (the third main path): a raw K-Radar tree of ten frames
   (eight train, one val, one test) at K-Radar's shapes is written to a
   temporary directory, then
   ``dpft_tpu_torch.prepare.main`` runs on it with config/kradar.json on
   the default device. Checked: the twelve files of every frame, the plane
   shapes, ``ra.npy`` / ``ea.npy`` against the plain version, exact launch
   counts (one of each radar kernel per frame, no MSDA launch; counts
   reset right before, read right after). One split is then read back
   through the port's dataset and loader and run through the flagship
   model. Printed: frames per second, the peak device memory of the run
   (eight workers hold a cube each) and the per-frame split.

The kernel report gives, for every kernel, its launches on the three main
paths, its error against the plain version, its time, the plain version's,
and ``bound_ms``: the least time the card could take, the larger of the
bytes the function must move (every input read once, every output written
once; for MSDA only the 32-byte sectors of the value map that this run's
sampling points touch) over 3.35 TB/s and its float32 operations over
67 TFLOP/s. ``library_ms`` is null: no single PyTorch call computes MSDA or
either radar plane.

The last two lines are the kernel report and the result:
    {"kernels": [...]}
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}
"""

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# Flagship MSDA geometry of config/kradar.json (per view).
B1, N_QUERIES, HEADS, HEAD_DIM, POINTS = 1, 400, 8, 2, 4
B_TRAIN = 4  # train.batch_size of config/kradar.json
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
REPS = 20  # timed forwards of the evaluator's latency phase
CALLS = 12  # MSDA calls per forward: 4 iterations x 3 views

# Published peaks of one H100 SXM: device memory rate and float32 rate
# outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# Radar cubes (doppler, range, elevation, azimuth): small ones with odd and
# even elevation counts and non-power-of-two axes, then K-Radar's.
KRADAR_CUBE = (64, 256, 37, 107)
RADAR_SHAPES = ((16, 32, 5, 9), (16, 32, 6, 9), (8, 32, 6, 10), (12, 24, 3, 5),
                KRADAR_CUBE)
RADAR_TOL = dict(rtol=3e-4, atol=3e-2)
# The least typical size of a reference channel that this tolerance can
# check: 30 times atol.
RADAR_FLOOR = 30 * RADAR_TOL["atol"]

# Real sample ids of sequence 10 from the frozen split tables, so that the
# processor's split filter keeps them: eight train frames, one val, one
# test. The processor's thread pool is per sequence and split, so the eight
# train frames are reduced by eight workers at once.
SEQUENCE = "10"
FRAME_IDS = {"train": tuple(f"{27 + i:05d}_{1 + i:05d}" for i in range(8)),
             "val": ("00039_00013",), "test": ("00309_00283",)}
SAMPLE_FILES = ("labels.npy", "description.npy", "mono.jpg", "mono_info.npy",
                "stereo.jpg", "stereo_info.npy", "ra.npy", "ra_info.npy",
                "ea.npy", "ea_info.npy", "os1.npy", "os2.npy")


def _run(cmd):
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, check=True)
    except (OSError, subprocess.CalledProcessError) as exc:
        return f"unavailable ({exc})"
    return out.stdout.strip()


def _cuda_ms(fn, reps=50, warmup=5):
    """Mean device time of ``fn`` in ms by CUDA events over ``reps``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(n_bytes, flops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    float32 operations over the peak rate."""
    by_bytes = 1e3 * n_bytes / PEAK_BYTES_PER_S
    by_ops = 1e3 * flops / PEAK_F32_FLOPS
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def _kernel_wrappers():
    from dpft_tpu_torch.ops import deform_attn as da
    from dpft_tpu_torch.ops import radar_reduce as rr

    return {"msda_fwd": da.msda_fwd, "msda_bwd": da.msda_bwd,
            "radar_reduce_ra": rr.radar_reduce_ra,
            "radar_reduce_ea": rr.radar_reduce_ea}


def _reset_launches():
    for wrapper in _kernel_wrappers().values():
        wrapper.launches = 0


def _read_launches():
    return {name: w.launches for name, w in _kernel_wrappers().items()}


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        raise SystemExit(2)
    from dpft_tpu_torch.ops import kernels

    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    print(smi.splitlines()[0] if smi else smi)
    nvcc = _run([kernels.nvcc_path(), "--version"]).splitlines()[-1]
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "not installed"
    print(f"[device] {torch.cuda.get_device_name(0)} count="
          f"{torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda} nvcc='{nvcc}' triton={triton_version}")


def phase_build():
    from dpft_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    info = kernels.build()
    kernels.library()
    seconds = time.perf_counter() - t0
    print(f"[build] {os.path.relpath(info.path, ROOT)} in {seconds:.2f} s "
          f"(nvcc {info.seconds:.2f} s)")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")


def _msda_inputs(shapes, B, N, H, D, P, dtype, lo, hi, seed):
    rng = np.random.default_rng(seed)
    L = len(shapes)
    Len = sum(h * w for h, w in shapes)
    value = torch.tensor(rng.normal(size=(B, Len, H, D)), dtype=dtype,
                         device="cuda")
    loc = torch.tensor(rng.uniform(lo, hi, size=(B, N, H, L, P, 2)),
                       dtype=torch.float32, device="cuda")
    att = rng.uniform(size=(B, N, H, L, P))
    att /= att.reshape(B, N, H, -1).sum(-1)[..., None, None]
    return value, loc, torch.tensor(att, dtype=dtype, device="cuda")


def _msda_value_bytes(value, shapes, loc):
    """Bytes of ``value`` in the distinct 32-byte sectors that the sampling
    points of ``loc`` touch (corners inside the map only)."""
    B, Len, H, D = value.shape
    item = value.element_size()
    b = torch.arange(B, device=loc.device).view(B, 1, 1, 1)
    h_idx = torch.arange(H, device=loc.device).view(1, 1, H, 1)
    sectors = []
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        x0 = torch.floor(loc[:, :, :, lvl, :, 0] * w - 0.5).long()
        y0 = torch.floor(loc[:, :, :, lvl, :, 1] * h - 0.5).long()
        for dy in (0, 1):
            for dx in (0, 1):
                xi, yi = x0 + dx, y0 + dy
                inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                first = (((b * Len + start + yi * w + xi) * H + h_idx) * D
                         * item)[inside]
                sectors += [first // 32, (first + D * item - 1) // 32]
        start += h * w
    return 32 * torch.unique(torch.cat(sectors)).numel()


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _msda_cases(view_shapes, B):
    cases = [("small_d3", ((6, 9), (3, 5), (2, 3), (1, 601)), 2, 7, 4, 3, 4),
             ("small_d2", ((6, 9), (3, 5), (2, 3)), 2, 7, 4, 2, 4)]
    for name, shapes in view_shapes.items():
        cases.append((name, shapes, B, N_QUERIES, HEADS, HEAD_DIM, POINTS))
    return cases


def phase_kernel_vs_plain(view_shapes):
    """Returns the kernel report entry (errors and camera-call times)."""
    from dpft_tpu_torch.ops import deform_attn as da

    max_err = 0.0
    times = None
    for case, shapes, B, N, H, D, P in _msda_cases(view_shapes, B1):
        for dtype in (torch.float32, torch.bfloat16):
            args = _msda_inputs(shapes, B, N, H, D, P, dtype, -0.2, 1.2,
                                seed=0)
            with torch.inference_mode():
                got = da.msda_fwd(args[0], shapes, *args[1:])
                torch.cuda.synchronize()
                want = da.ms_deform_attn_core_plain(args[0], shapes, *args[1:])
            err = (got.float() - want.float()).abs().max().item()
            tol = TOL[dtype]
            if not torch.allclose(got.float(), want.float(), atol=tol,
                                  rtol=tol):
                raise AssertionError(f"msda_fwd {case} {dtype}: max abs err "
                                     f"{err:.3e} exceeds {tol}")
            if dtype == torch.float32:
                max_err = max(max_err, err)
            print(f"[msda] {case} {str(dtype)[6:]} shapes={list(shapes)} "
                  f"max_abs_err={err:.3e} (tol {tol}) ok")
            if case == "camera_mono" and dtype == torch.float32:
                with torch.inference_mode():
                    k_ms = _cuda_ms(lambda: da.msda_fwd(args[0], shapes,
                                                        *args[1:]))
                    p_ms = _cuda_ms(lambda: da.ms_deform_attn_core_plain(
                        args[0], shapes, *args[1:]), reps=20)
                times = (k_ms, p_ms)
                # Sampled value sectors, locations and weights read once,
                # the output written once; 10 operations per corner.
                bound = _bound(
                    _msda_value_bytes(args[0], shapes, args[1])
                    + _nbytes(args[1], args[2], got),
                    10 * 4 * args[2].numel() * D)
                print(f"[msda] camera f32 one call: kernel {k_ms:.4f} ms, "
                      f"plain {p_ms:.4f} ms, bound {bound[0]:.5f} ms "
                      f"({bound[1]})")
    return {"name": "msda_fwd", "route": "cuda",
            "source": "dpft_tpu_torch/csrc/msda_fwd.cu",
            "replaces": "dpft_tpu/ops/pallas/deform_attn.py:60",
            "max_abs_err": max_err, "ms": times[0], "plain_ms": times[1],
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None}


def _to_cuda(batch):
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def phase_flagship(config, model):
    import dpft_tpu_torch.models.layers.ms_deform_attn as msda_layer
    from dpft_tpu_torch.ops import deform_attn as da
    from dpft_tpu_torch.utils.example import example_batch

    batch = _to_cuda(example_batch(config, B=1, cam_hw=(512, 910)))
    with torch.inference_mode():
        out = model(batch)
        # The same model with the plain core, swapped in this process only.
        msda_layer.ms_deform_attn_core = da.ms_deform_attn_core_plain
        try:
            ref = model(batch)
        finally:
            msda_layer.ms_deform_attn_core = da.ms_deform_attn_core
    expect = {"class": 2, "center": 3, "size": 3, "angle": 2}
    for key, width in expect.items():
        got, want = out[key], ref[key]
        if tuple(got.shape) != (1, N_QUERIES, width):
            raise AssertionError(f"{key}: shape {tuple(got.shape)}")
        if not torch.isfinite(got).all():
            raise AssertionError(f"{key}: non-finite outputs")
        err = (got - want).abs().max().item()
        if not torch.allclose(got, want, atol=1e-4, rtol=1e-4):
            raise AssertionError(f"{key}: kernel model vs plain-core model "
                                 f"max abs err {err:.3e} exceeds 1e-4")
        print(f"[flagship] B=1 f32 {key} {tuple(got.shape)} finite, kernel "
              f"vs plain core max_abs_err={err:.3e} (tol 1e-4) ok")

    for dtype in (torch.float32, torch.bfloat16):
        model.compute_dtype = dtype
        for B in (1, 4):
            batch = _to_cuda(example_batch(config, B=B, cam_hw=(512, 910)))
            torch.cuda.reset_peak_memory_stats()
            with torch.inference_mode():
                ms = _cuda_ms(lambda: model(batch), reps=20, warmup=3)
                out = model(batch)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            if not all(torch.isfinite(v).all() for v in out.values()):
                raise AssertionError(f"non-finite outputs at B={B} {dtype}")
            print(f"[flagship] B={B} {str(dtype)[6:]}: {ms:.3f} ms/batch, "
                  f"{ms / B:.3f} ms/frame, peak memory {peak:.3f} GiB")
    model.compute_dtype = torch.float32


class _Loader:
    """Synthetic batches with K-Radar targets, in memory."""

    def __init__(self, config, B=1, n=2, seed=0):
        from dpft_tpu_torch.utils.example import (example_batch,
                                                  example_targets)

        self.batches = []
        for i in range(n):
            targets = example_targets(config, B=B, seed=10 + seed + i)
            targets["description"] = np.tile(np.array([[0, 0, 0]]), (B, 1))
            self.batches.append((example_batch(config, B=B,
                                               cam_hw=(512, 910),
                                               seed=seed + i), targets))
        self.batch_size = B

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def phase_serve(config, model):
    """The serving path; returns its launches of every kernel."""
    from dpft_tpu_torch.evaluation import CentralizedEvaluator
    from dpft_tpu_torch.models import registry

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "run", "2026-01-01-00-00-00_checkpoint_0001.pt")
        registry.save(model, config, ckpt)
        evaluator = CentralizedEvaluator.from_config(config, device="cuda",
                                                     repetitions=REPS)
        dst = os.path.join(tmp, "log")
        _reset_launches()
        results = evaluator(ckpt, _Loader(config), dst)
        launches = _read_launches()
        tree = os.path.join(dst, "2026-01-01-00-00-00", "exports", "kradar")
        files = [os.path.join(d, f) for d, _, fs in os.walk(tree) for f in fs]
        for sub in ("preds", "gts", "desc"):
            if not os.path.isfile(os.path.join(tree, "0.0", "all", sub,
                                               "000001.txt")):
                raise AssertionError(f"exporter wrote no {sub}/000001.txt")
    # 2 batches + warm-up + timed forwards, 4 iterations x 3 views each;
    # serving runs no backward and reduces no radar cube.
    expected = {"msda_fwd": (2 + evaluator.warmup + REPS) * 12,
                "msda_bwd": 0, "radar_reduce_ra": 0, "radar_reduce_ea": 0}
    if launches != expected:
        raise AssertionError(f"the serving path launched {launches}, "
                             f"expected {expected}")
    print(f"[serve] save -> load -> evaluate -> export: {len(files)} files; "
          f"results {json.dumps(results)}; launches {launches}")
    return launches


def _plain_grads(value, shapes, loc, att, grad_out):
    from dpft_tpu_torch.ops import deform_attn as da

    inputs = [t.detach().float().requires_grad_(True)
              for t in (value, loc, att)]
    out = da.ms_deform_attn_core_plain(inputs[0], shapes, *inputs[1:])
    return torch.autograd.grad(out, inputs, grad_out.float())


def phase_bwd_vs_plain(view_shapes):
    """Returns the kernel report entry of msda_bwd."""
    from dpft_tpu_torch.ops import deform_attn as da

    max_err = 0.0
    times = None
    for case, shapes, B, N, H, D, P in _msda_cases(view_shapes, B_TRAIN):
        value, loc, att = _msda_inputs(shapes, B, N, H, D, P, torch.float32,
                                       -0.2, 1.2, seed=1)
        grad_out = torch.randn(B, N, H * D, device="cuda",
                               generator=torch.Generator("cuda").manual_seed(2))
        want = _plain_grads(value, shapes, loc, att, grad_out)
        for dtype in (torch.float32, torch.bfloat16):
            args = (value.to(dtype), shapes, loc, att.to(dtype),
                    grad_out.to(dtype))
            got = da.msda_bwd(*args)
            torch.cuda.synchronize()
            errs = []
            for name, g, w in zip(("d_value", "d_loc", "d_att"), got, want):
                if g.shape != w.shape or g.dtype != (
                        torch.float32 if name == "d_loc" else dtype):
                    raise AssertionError(f"msda_bwd {case} {name}: "
                                         f"{g.dtype} {tuple(g.shape)}")
                err = (g.float() - w).abs().max().item()
                scale = w.abs().max().item()
                tol = BWD_TOL[dtype]
                bound = tol * (1.0 + scale) if dtype == torch.float32 \
                    else tol * scale
                if not err <= bound:
                    raise AssertionError(
                        f"msda_bwd {case} {str(dtype)[6:]} {name}: max abs "
                        f"err {err:.3e} exceeds {bound:.3e}")
                errs.append(f"{name}={err:.3e} ({err / max(scale, 1e-30):.1e}"
                            " of max)")
                if dtype == torch.float32:
                    max_err = max(max_err, err)
            print(f"[msda_bwd] {case} B={B} {str(dtype)[6:]} "
                  f"{' '.join(errs)} (tol {BWD_TOL[dtype]}) ok")
        if case == "camera_mono":
            args = (value, shapes, loc, att, grad_out)
            k_ms = _cuda_ms(lambda: da.msda_bwd(*args), reps=20)
            inputs = [t.detach().requires_grad_(True)
                      for t in (value, loc, att)]
            out = da.ms_deform_attn_core_plain(inputs[0], shapes,
                                               *inputs[1:])
            p_ms = _cuda_ms(lambda: torch.autograd.grad(
                out, inputs, grad_out, retain_graph=True), reps=10)
            times = (k_ms, p_ms)
            # Read once: sampled value sectors, locations, weights and
            # grad_out; written once: d_value (all of it), d_loc, d_att;
            # 30 operations per corner.
            roof = _bound(
                _msda_value_bytes(value, shapes, loc)
                + _nbytes(loc, att, grad_out) + _nbytes(value, loc, att),
                30 * 4 * att.numel() * D)
            print(f"[msda_bwd] camera B={B} f32 one backward: kernel "
                  f"{k_ms:.4f} ms, plain (autograd) {p_ms:.4f} ms, bound "
                  f"{roof[0]:.5f} ms ({roof[1]})")
    return {"name": "msda_bwd", "route": "cuda",
            "source": "dpft_tpu_torch/csrc/msda_bwd.cu",
            "replaces": "dpft_tpu/ops/pallas/deform_attn.py:177",
            "max_abs_err": max_err, "ms": times[0], "plain_ms": times[1],
            "bound_ms": roof[0], "bound_by": roof[1], "library_ms": None}


def _cuda_batch(config, seed):
    from dpft_tpu_torch.utils.example import example_batch, example_targets

    return (_to_cuda(example_batch(config, B=B_TRAIN, cam_hw=(512, 910),
                                   seed=seed)),
            _to_cuda(example_targets(config, B=B_TRAIN, seed=seed)))


def phase_train_step_vs_plain(config, model):
    """One train step of the kernel model against the plain-core model."""
    import dpft_tpu_torch.models.layers.ms_deform_attn as msda_layer
    from dpft_tpu_torch.ops import deform_attn as da
    from dpft_tpu_torch.training import CentralizedTrainer

    trainer = CentralizedTrainer.from_config(config)
    batch, targets = _cuda_batch(config, seed=20)
    results = []
    for core in (da.ms_deform_attn_core, da.ms_deform_attn_core_plain):
        msda_layer.ms_deform_attn_core = core
        try:
            model.zero_grad(set_to_none=True)
            torch.manual_seed(3)  # the same dropout masks
            loss = trainer.train_step(model, batch, targets)["loss"]
        finally:
            msda_layer.ms_deform_attn_core = da.ms_deform_attn_core
        results.append((loss, {k: p.grad.clone() for k, p in
                               model.named_parameters()
                               if p.grad is not None}))
    model.zero_grad(set_to_none=True)
    (loss, grads), (ref_loss, ref_grads) = results
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    if not (math.isfinite(loss) and loss_err <= 1e-4):
        raise AssertionError(f"train step loss {loss} vs plain core "
                             f"{ref_loss}: relative err {loss_err:.3e}")
    if set(grads) != set(ref_grads):
        raise AssertionError("kernel and plain-core steps reach different "
                             "parameters")
    worst = (0.0, "")
    for k, g in grads.items():
        ref = ref_grads[k]
        err = ((g - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()
        if not err <= 1e-3:
            raise AssertionError(f"gradient of {k}: err {err:.3e} of its max "
                                 "exceeds 1e-3")
        worst = max(worst, (err, k))
    print(f"[train] B={B_TRAIN} f32 step, kernel model vs plain-core model: "
          f"loss {loss:.6f} vs {ref_loss:.6f} (rel err {loss_err:.3e}, tol "
          f"1e-4); {len(grads)} gradients, worst {worst[0]:.3e} of its max "
          f"at {worst[1]} (tol 1e-3) ok")


def phase_train(config, model):
    """The train path; returns its launches of every kernel."""
    from dpft_tpu_torch.models import registry
    from dpft_tpu_torch.training import CentralizedTrainer

    config = json.loads(json.dumps(config))
    config["train"]["epochs"] = 2
    train_loader = _Loader(config, B=B_TRAIN, n=4, seed=30)
    val_loader = _Loader(config, B=B_TRAIN, n=2, seed=40)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with tempfile.TemporaryDirectory() as dst:
        trainer = CentralizedTrainer.from_config(config)
        _reset_launches()
        run = trainer(model, train_loader, val_loader, dst=dst,
                      timestamp="2026-01-01-00-00-00")
        launches = _read_launches()
        steps = 2 * len(train_loader.batches)
        val = 2 * len(val_loader.batches)
        expected = {"msda_fwd": CALLS * (steps + val),
                    "msda_bwd": CALLS * steps,
                    "radar_reduce_ra": 0, "radar_reduce_ea": 0}
        if launches != expected:
            raise AssertionError(f"the train path launched {launches}, "
                                 f"expected {expected}")
        with open(os.path.join(dst, run["timestamp"], "scalars.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        losses = [r["loss"] for r in rows]
        if not (all(map(math.isfinite, losses)) and len(rows) == 4):
            raise AssertionError(f"train scalars: {rows}")
        for key in ("mAP", "mGIoU"):
            if not math.isfinite(run["result"].get(key, math.nan)):
                raise AssertionError(f"no validation {key}: {run['result']}")
        changed = sum(not torch.equal(v, before[k])
                      for k, v in model.state_dict().items())
        if not changed:
            raise AssertionError("training changed no parameter")
        ckpts = [os.path.join(dst, run["timestamp"], "checkpoints",
                              f"{run['timestamp']}_checkpoint_{e:04d}.pt")
                 for e in range(2)]
        if not all(map(os.path.isfile, ckpts)):
            raise AssertionError(f"missing checkpoints: {ckpts}")
        print(f"[train] CentralizedTrainer 2 epochs x {steps // 2} steps + "
              f"{val // 2} val batches, B={B_TRAIN} f32: losses "
              f"{[round(x, 4) for x in losses]}; val {json.dumps(run['result'])}"
              f"; {changed} state tensors changed; checkpoints written; "
              f"launches {launches}")

        # Resume from the epoch-0 checkpoint: one more epoch.
        resumed, _, epoch, timestamp = registry.load(ckpts[0], config,
                                                     "cuda")
        _reset_launches()
        again = CentralizedTrainer.from_config(config)(
            resumed, train_loader, val_loader, start_epoch=epoch + 1,
            timestamp=timestamp, dst=dst)
        resume_launches = _read_launches()
        want = {k: v // 2 for k, v in expected.items()}
        if resume_launches != want or len(again["history"]) != 1:
            raise AssertionError(f"resume launched {resume_launches} over "
                                 f"{len(again['history'])} epochs, expected "
                                 f"{want} over 1")
        print(f"[train] resumed from epoch 0 under {timestamp}: 1 epoch, "
              f"loss {again['history'][0]:.4f}, launches {resume_launches}")
        del resumed
    return launches


def phase_train_timing(config, model):
    """Step time, host share of matching and peak memory at B=4."""
    from dpft_tpu_torch.training import CentralizedTrainer

    trainer = CentralizedTrainer.from_config(config)
    optimizer = trainer.optimizer_factory(model.parameters())
    batch, targets = _cuda_batch(config, seed=50)
    match = trainer.loss_fn.match
    host = []

    def timed_match(out, tgt):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        indices = match(out, tgt)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
        return indices

    trainer.loss_fn.match = timed_match
    for dtype in (torch.float32, torch.bfloat16):
        model.compute_dtype = dtype
        torch.cuda.reset_peak_memory_stats()
        times, walls = [], []
        for i in range(13):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            trainer.train_step(model, batch, targets)
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            end.record()
            torch.cuda.synchronize()
            if i >= 3:
                times.append(start.elapsed_time(end))
                walls.append(time.perf_counter() - t0)
            else:
                host.clear()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        share = sum(host[-10:]) / sum(walls)
        print(f"[train] B={B_TRAIN} {str(dtype)[6:]} step (forward, matching,"
              f" loss, metric, backward, AdamW): {np.mean(times):.3f} ms "
              f"(std {np.std(times):.3f}, 10 steps by CUDA events); matching "
              f"on the host {1e3 * np.mean(host[-10:]):.3f} ms = "
              f"{100 * share:.1f}% of the step; peak memory {peak:.3f} GiB")
    model.compute_dtype = torch.float32


def _power_cube(shape, seed):
    """Strictly positive float32 powers (75 to 125 dB) from a numpy seed:
    uniform powers times a gain per doppler bin that spans 10 dB, as the
    doppler bins of a real cube differ. Without the gain the inner maxima
    would be nearly equal in every doppler bin, and their variance over
    doppler (channel 5) would lie below the tolerance that checks it."""
    rng = np.random.default_rng(seed)
    power = 1e8 + rng.random(shape, dtype=np.float32) * np.float32(1e12 - 1e8)
    gain = 10.0 ** rng.uniform(-0.5, 0.5, size=(shape[0], 1, 1, 1))
    return (power * gain.astype(np.float32)).astype(np.float32)


def _check_plane(what, got, want, exact_lookup=True):
    """Holds a (.., 6) plane against its reference, channel by channel.
    Returns the max abs err, the number of lookups that differ, and per
    channel the typical size of the reference (median of its absolute
    values) and the max abs err."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype} {tuple(got.shape)} vs "
                             f"{want.dtype} {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    typical = [want[..., c].abs().median().item() for c in range(6)]
    errs = [(got[..., c] - want[..., c]).abs().max().item() for c in range(6)]
    # Channel 3 is a table lookup: it is equal or it is another bin.
    for c in (0, 1, 2, 4, 5):
        # A channel whose values are no larger than the tolerance would be
        # checked by nothing: a zero in its place would pass.
        if typical[c] < RADAR_FLOOR:
            raise AssertionError(
                f"{what}: channel {c} of the reference is typically "
                f"{typical[c]:.3e}, too small for atol {RADAR_TOL['atol']} "
                "to tell a wrong value from a right one")
        if not torch.allclose(got[..., c], want[..., c], **RADAR_TOL):
            raise AssertionError(f"{what}: channel {c} max abs err "
                                 f"{errs[c]:.3e} exceeds {RADAR_TOL}")
    mismatches = int((got[..., 3] != want[..., 3]).sum())
    if exact_lookup and mismatches:
        raise AssertionError(f"{what}: {mismatches} doppler-of-max lookups "
                             "differ")
    err = max(errs[c] for c in (0, 1, 2, 4, 5))
    return err, mismatches, typical, errs


def _channels(values):
    return "[" + ", ".join(f"{v:.2e}" for v in values) + "]"


def _check_limits(rr):
    """Beyond the kernels' limits a CUDA cube raises and launches nothing."""
    # RA: 4 * (96 * 64 + 512 * 128) bytes of shared memory; EA: 4 * 248 * 300.
    cases = ((rr.radar_reduce_ra, (64, 8, 128, 4)),
             (rr.radar_reduce_ea, (2, 256, 1, 300)))
    for wrapper, shape in cases:
        before = wrapper.launches
        try:
            wrapper(torch.ones(shape, device="cuda"))
        except RuntimeError as exc:
            if "limits" not in str(exc) or wrapper.launches != before:
                raise
        else:
            raise AssertionError(f"{wrapper.__name__} accepted {shape}, "
                                 "beyond its shared-memory limit")
    print("[radar] beyond the shared-memory limit both wrappers raise and "
          "launch nothing, ok")


def _radar_bounds(shape):
    """Bounds of the two kernels: RA reads the whole cube, EA the range
    rows [4, 252); per element about 6 operations (dB, max, sum, centred
    square) and log2(n) comparisons of a sort over the reduced axis."""
    D, R, E, A = shape
    rows = min(252, R) - 4
    ra = _bound(4 * (D * R * E * A + R * A * 6),
                D * R * E * A * (6 + math.log2(E)))
    ea = _bound(4 * (D * rows * E * A + E * A * 6),
                D * rows * E * A * (6 + math.log2(rows)))
    return ra, ea


def phase_radar_vs_plain():
    """Returns the kernel report entries of both radar kernels."""
    from dpft_tpu_torch.ops import radar_reduce as rr

    max_err = {"ra": 0.0, "ea": 0.0}
    for shape in RADAR_SHAPES:
        host = _power_cube(shape, seed=0)
        cube = torch.from_numpy(host).cuda()
        ra = rr.radar_reduce_ra(cube)
        ea = rr.radar_reduce_ea(cube)
        torch.cuda.synchronize()
        want_ra, want_ea = rr.reduce_tesseract_plain(cube)
        errs = {"ra": _check_plane(f"radar_reduce_ra {shape}", ra, want_ra),
                "ea": _check_plane(f"radar_reduce_ea {shape}", ea, want_ea)}
        for key in max_err:
            max_err[key] = max(max_err[key], errs[key][0])
        print(f"[radar] {shape} kernel vs plain: ra max_abs_err="
              f"{errs['ra'][0]:.3e}, ea max_abs_err={errs['ea'][0]:.3e} "
              f"(rtol {RADAR_TOL['rtol']}, atol {RADAR_TOL['atol']}), "
              "lookup channel exact, ok")
        for key in ("ra", "ea"):
            print(f"[radar]   {key} channels 0-5: typical |value| "
                  f"{_channels(errs[key][2])}, max abs err "
                  f"{_channels(errs[key][3])}")
    if tuple(ra.shape) != (256, 107, 6) or tuple(ea.shape) != (37, 107, 6):
        raise AssertionError(f"planes {tuple(ra.shape)} {tuple(ea.shape)}")

    # The last cube is K-Radar's: the third opinion, on the host. numpy's
    # float32 log10 differs from CUDA's in the last bit, which moves the
    # argmax where two doppler bins tie within that bit, so the lookup
    # channel is held to 1% of the pixels here and exactly only above.
    t0 = time.perf_counter()
    np_ra, np_ea = rr.reduce_tesseract_np(host)
    np_s = time.perf_counter() - t0
    for name, got, want in (("ra", ra, np_ra), ("ea", ea, np_ea)):
        want = torch.from_numpy(want.astype(np.float32)).cuda()
        err, mismatches, _, _ = _check_plane(
            f"radar_reduce_{name} vs numpy", got, want, exact_lookup=False)
        pixels = got[..., 3].numel()
        if mismatches > 0.01 * pixels:
            raise AssertionError(f"radar_reduce_{name} vs numpy: {mismatches}"
                                 f" of {pixels} lookups differ")
        print(f"[radar] {shape} {name} kernel vs numpy on the host: "
              f"max_abs_err={err:.3e}, {mismatches} of {pixels} lookups "
              "differ (ties within one bit of log10), ok")
    print(f"[radar] numpy on the host: {np_s:.2f} s for one cube")
    _check_limits(rr)

    ra_ms = _cuda_ms(lambda: rr.radar_reduce_ra(cube), reps=20, warmup=2)
    ea_ms = _cuda_ms(lambda: rr.radar_reduce_ea(cube), reps=20, warmup=2)
    plain_ms = _cuda_ms(lambda: rr.reduce_tesseract_plain(cube), reps=3,
                        warmup=1)
    ra_bound, ea_bound = _radar_bounds(shape)
    print(f"[radar] {shape} one cube: radar_reduce_ra {ra_ms:.4f} ms (bound "
          f"{ra_bound[0]:.4f} ms, {ra_bound[1]}), radar_reduce_ea "
          f"{ea_ms:.4f} ms (bound {ea_bound[0]:.4f} ms, {ea_bound[1]}), "
          f"plain version of both planes {plain_ms:.3f} ms")

    # Host to card: one cube from pageable and from pinned memory; the
    # bound is the card's own memory rate, which the bus does not reach.
    pinned = torch.from_numpy(host).pin_memory()
    pageable = torch.from_numpy(host)
    copy_bound = 1e3 * host.nbytes / PEAK_BYTES_PER_S
    page_ms = _cuda_ms(lambda: pageable.to("cuda"), reps=5, warmup=1)
    pin_ms = _cuda_ms(lambda: pinned.to("cuda", non_blocking=True), reps=5,
                      warmup=1)
    print(f"[radar] copy of one cube ({host.nbytes / 1e6:.1f} MB) to the "
          f"card: pageable {page_ms:.3f} ms ({host.nbytes / page_ms / 1e6:.2f}"
          f" GB/s), pinned {pin_ms:.3f} ms ({host.nbytes / pin_ms / 1e6:.2f} "
          f"GB/s); {copy_bound:.4f} ms at the card's memory rate")

    def report(name, line, ms, bound, err):
        # The plain version computes both planes in one call; its time
        # stands beside each kernel.
        return {"name": name, "route": "cuda",
                "source": "dpft_tpu_torch/csrc/radar_reduce.cu",
                "replaces": f"dpft_tpu/ops/pallas/radar_reduce.py:{line}",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": None}

    return (report("radar_reduce_ra", 112, ra_ms, ra_bound, max_err["ra"]),
            report("radar_reduce_ea", 163, ea_ms, ea_bound, max_err["ea"]))


def _write_raw_kradar(root):
    """A raw K-Radar tree of the frames of FRAME_IDS at K-Radar's shapes,
    from seeds: label and calibration txt, a 720 x 2560 stereo PNG, a
    float64 (64, 256, 37, 107) ``arrDREA`` .mat, a 128 x 1024 and a
    64 x 1024 point cloud per frame."""
    from concurrent.futures import ThreadPoolExecutor

    import cv2
    from scipy.io import savemat

    from dpft_tpu_torch.data.pcd import write_pcd

    src = os.path.join(root, "raw")
    base = os.path.join(src, SEQUENCE)
    for sub in ("info_label_v2", "info_calib", "cam-front", "radar_tesseract",
                "os1-128", "os2-64"):
        os.makedirs(os.path.join(base, sub))
    with open(os.path.join(base, "description.txt"), "w") as f:
        f.write("urban,day,normal")
    with open(os.path.join(base, "info_calib", "calib_camera_lidar.txt"),
              "w") as f:
        f.write("header\n560.0,0.0,640.0,0.0,0.0,560.0,360.0,0.0,0.0,0.0,1.0,"
                "0.0")
    with open(os.path.join(base, "info_calib", "calib_radar_lidar.txt"),
              "w") as f:
        f.write("header\n0,2.54,0.3")  # frame difference, dx, dy

    def write_frame(item):
        k, sid = item
        rng = np.random.default_rng(100 + k)
        idx = sid.split("_")[0]
        with open(os.path.join(base, "info_label_v2", f"{sid}.txt"), "w") as f:
            f.write(f"timestamp={idx}_{idx}_{idx}_{idx}_{idx}\n"
                    "*, 0, Sedan, 20.0, 1.0, 0.5, 10.0, 2.0, 1.0, 0.8\n"
                    "*, 1, Sedan, 40.0, -2.0, 0.2, -5.0, 2.2, 0.9, 0.7\n"
                    "*, 2, Bus or Truck, 30.0, 3.0, 0.5, 0.0, 4.0, 1.5, 1.5\n")
        stereo = rng.integers(0, 255, size=(720, 2560, 3), dtype=np.uint8)
        if not cv2.imwrite(os.path.join(base, "cam-front",
                                        f"cam-front_{idx}.png"), stereo):
            raise AssertionError("cv2 could not write the stereo PNG")
        savemat(os.path.join(base, "radar_tesseract", f"tesseract_{idx}.mat"),
                {"arrDREA": _power_cube(KRADAR_CUBE, 200 + k).astype(
                    np.float64)})
        for name, rings in (("os1-128", 128), ("os2-64", 64)):
            n = rings * 1024
            write_pcd(os.path.join(base, name, f"{name}_{idx}.pcd"), {
                "x": rng.uniform(0.5, 60, n).astype(np.float32),
                "y": rng.uniform(-10, 10, n).astype(np.float32),
                "z": rng.uniform(-2, 4, n).astype(np.float32),
                "intensity": rng.uniform(0, 255, n).astype(np.float32),
                "t": rng.integers(0, 1_000_000, n).astype(np.uint32),
                "reflectivity": rng.integers(0, 65535, n).astype(np.uint16),
                "ring": rng.integers(0, rings, n).astype(np.uint8),
                "ambient": rng.integers(0, 65535, n).astype(np.uint16),
                "range": rng.integers(0, 200_000, n).astype(np.uint32)})

    ids = [sid for split in FRAME_IDS.values() for sid in split]
    with ThreadPoolExecutor(max_workers=5) as pool:
        list(pool.map(write_frame, enumerate(ids)))
    return src


def _host_s(fn):
    """(result, seconds) of ``fn`` on the host clock, the card drained."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_prepare(config_path, config, model):
    """The prepare path; returns its launches of every kernel."""
    from dpft_tpu_torch import prepare
    from dpft_tpu_torch.data import init as init_dataset
    from dpft_tpu_torch.data import load as load_dataset
    from dpft_tpu_torch.data import prepare as build_processor
    from dpft_tpu_torch.evaluation.evaluator import to_device
    from dpft_tpu_torch.ops import radar_reduce as rr

    root = tempfile.mkdtemp(prefix="dpft_prepare_")
    try:
        src, write_s = _host_s(lambda: _write_raw_kradar(root))
        dst = os.path.join(root, "processed")
        n_frames = sum(map(len, FRAME_IDS.values()))
        print(f"[prepare] wrote a raw tree of {n_frames} frames at "
              f"{KRADAR_CUBE} in {write_s:.1f} s")

        held = torch.cuda.memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        _, run_s = _host_s(lambda: prepare.main(src, config_path, dst))
        launches = _read_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        expected = {"msda_fwd": 0, "msda_bwd": 0,
                    "radar_reduce_ra": n_frames, "radar_reduce_ea": n_frames}
        if launches != expected:
            raise AssertionError(f"the prepare path launched {launches}, "
                                 f"expected {expected}")

        # The tree, the planes' shapes, and the planes against the plain
        # version on the same cube.
        processor = build_processor(config["dataset"], config)
        worst = {"ra": 0.0, "ea": 0.0}
        for split, ids in FRAME_IDS.items():
            frames = sorted(os.listdir(os.path.join(dst, split, SEQUENCE)))
            if frames != sorted(ids):
                raise AssertionError(f"{split}: frames {frames}, expected "
                                     f"{sorted(ids)}")
            for sid in ids:
                out = os.path.join(dst, split, SEQUENCE, sid)
                if sorted(os.listdir(out)) != sorted(SAMPLE_FILES):
                    raise AssertionError(f"{out}: {sorted(os.listdir(out))}")
                cube = torch.from_numpy(processor.get_radar_tesseract(
                    os.path.join(src, SEQUENCE, "radar_tesseract",
                                 f"tesseract_{sid.split('_')[0]}.mat"))).cuda()
                for name, want in zip(("ra", "ea"),
                                      rr.reduce_tesseract_plain(cube)):
                    got = np.load(os.path.join(out, f"{name}.npy"))
                    if got.dtype != np.float32:
                        raise AssertionError(f"{name}.npy is {got.dtype}")
                    err = _check_plane(f"{sid}/{name}.npy",
                                       torch.from_numpy(got).cuda(), want)[0]
                    worst[name] = max(worst[name], err)
                labels = np.load(os.path.join(out, "labels.npy"))
                if labels.shape != (2, 9):
                    raise AssertionError(f"labels {labels.shape}")
        pools = "/".join(str(len(ids)) for ids in FRAME_IDS.values())
        print(f"[prepare] dpft_tpu_torch.prepare.main on cuda: {n_frames} "
              f"frames in {run_s:.2f} s = {n_frames / run_s:.3f} frames/s "
              f"(workers {config['computing']['workers']}; one pool per split"
              f" of {pools} frames, so at most {max(map(len, FRAME_IDS.values()))}"
              f" workers at once); peak device memory {peak:.3f} GiB, of "
              f"which {held:.3f} GiB were held before (the flagship model); "
              f"12 files per frame; ra (256, 107, 6) / ea (37, 107, 6) vs "
              f"plain max_abs_err {worst['ra']:.3e} / {worst['ea']:.3e}, "
              f"lookup channel exact; launches {launches}")

        # Where one frame's time goes, step by step on one worker.
        paths = processor.get_sequence_paths(
            processor.get_dataset_paths(src)["train"][SEQUENCE])
        description = paths.pop("description")
        sample = paths[FRAME_IDS["train"][0]]
        again = os.path.join(root, "again")
        _, frame_s = _host_s(lambda: processor.prepare_sample(
            sample, description, again))
        from scipy.io import loadmat
        raw, load_s = _host_s(
            lambda: loadmat(sample["radar_tesseract"])["arrDREA"])
        host, cast_s = _host_s(lambda: raw.astype(np.float32))
        cube, copy_s = _host_s(lambda: torch.from_numpy(host).cuda())
        planes, kernel_s = _host_s(lambda: rr.reduce_tesseract(cube))
        planes, back_s = _host_s(lambda: [p.cpu().numpy() for p in planes])
        _, save_s = _host_s(lambda: [
            np.save(os.path.join(again, f"{n}.npy"), p, allow_pickle=False)
            for n, p in zip(("ra", "ea"), planes)])
        radar_s = load_s + cast_s + copy_s + kernel_s + back_s + save_s
        print(f"[prepare] one frame on one worker: {frame_s:.3f} s = loadmat "
              f"{load_s:.3f} + astype {cast_s:.3f} + copy to the card "
              f"{copy_s:.4f} + both kernels {kernel_s:.4f} + planes back "
              f"{back_s:.4f} + ra/ea.npy {save_s:.4f} s (radar "
              f"{radar_s:.3f} s) + camera, lidar, labels and their files "
              f"{frame_s - radar_s:.3f} s; the kernels are "
              f"{100 * kernel_s / frame_s:.2f}% of the frame")

        # One split back through the port's dataset and loader, one batch
        # through the flagship model.
        dataset = init_dataset(config["dataset"], src=dst, split="train",
                               config=config)
        loader = load_dataset(dataset, config=config, shuffle=False,
                              pad_last=True)
        inputs, targets = next(iter(loader))
        B = config["train"]["batch_size"]
        if inputs["camera_mono"].shape != (B, 512, 910, 3) or \
                inputs["radar_bev"].shape != (B, 256, 107, 6) or \
                inputs["radar_front"].shape != (B, 37, 107, 6):
            raise AssertionError({k: v.shape for k, v in inputs.items()})
        if int(targets["sample_mask"].sum()) != min(B, len(dataset)) or \
                len(dataset) != len(FRAME_IDS["train"]):
            raise AssertionError(f"sample_mask {targets['sample_mask']}")
        model.eval()
        with torch.inference_mode():
            out = model(to_device(inputs, torch.device("cuda")))
        for key, width in (("class", 2), ("center", 3), ("size", 3),
                           ("angle", 2)):
            if tuple(out[key].shape) != (B, N_QUERIES, width) or \
                    not torch.isfinite(out[key]).all():
                raise AssertionError(f"{key}: {tuple(out[key].shape)}")
        print(f"[prepare] train split read back: {len(dataset)} samples, one "
              f"batch of {B} through the flagship model: finite "
              f"outputs of {N_QUERIES} queries; "
              f"{int(targets['gt_mask'].sum())} boxes in the batch")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def main():
    phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()

    from dpft_tpu_torch.models import registry
    from dpft_tpu_torch.utils.example import example_batch

    config_path = os.path.join(ROOT, "config", "kradar.json")
    with open(config_path) as f:
        config = json.load(f)
    t0 = time.perf_counter()
    model = registry.build(config["model"]["name"], config, device="cuda",
                           seed=0)
    print(f"[flagship] built config/kradar.json on cuda in "
          f"{time.perf_counter() - t0:.1f} s")
    with torch.inference_mode():
        views = model.features(_to_cuda(example_batch(config, B=1,
                                                      cam_hw=(512, 910))))
    view_shapes = dict(zip(model.inputs, (shapes for _, shapes in views)))
    del views

    fwd_report = phase_kernel_vs_plain(view_shapes)
    phase_flagship(config, model)
    serve_launches = phase_serve(config, model)
    bwd_report = phase_bwd_vs_plain(view_shapes)
    phase_train_step_vs_plain(config, model)
    train_launches = phase_train(config, model)
    phase_train_timing(config, model)
    ra_report, ea_report = phase_radar_vs_plain()
    prepare_launches = phase_prepare(config_path, config, model)
    # `launches` is the count on the kernel's own main path.
    reports = [(fwd_report, train_launches), (bwd_report, train_launches),
               (ra_report, prepare_launches), (ea_report, prepare_launches)]
    for report, own_path in reports:
        name = report["name"]
        report["launches"] = own_path[name]
        report["launches_by_path"] = {"serve": serve_launches[name],
                                      "train": train_launches[name],
                                      "prepare": prepare_launches[name]}
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    print(smi.splitlines()[0] if smi else smi)
    print(json.dumps({"kernels": [report for report, _ in reports]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
