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

The last two lines are the kernel report and the result:
    {"kernels": [...]}
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}
"""

import json
import math
import os
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
                print(f"[msda] camera f32 one call: kernel {k_ms:.4f} ms, "
                      f"plain {p_ms:.4f} ms")
    return {"name": "msda_fwd", "route": "cuda",
            "source": "dpft_tpu_torch/csrc/msda_fwd.cu",
            "replaces": "dpft_tpu/ops/pallas/deform_attn.py:60",
            "max_abs_err": max_err, "ms": times[0], "plain_ms": times[1]}


def _to_cuda(batch):
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def phase_flagship(config, model):
    import dpft_tpu_torch.models.layers.ms_deform_attn as msda_layer
    from dpft_tpu_torch.ops import deform_attn as da
    from __graft_entry__ import _example_batch

    batch = _to_cuda(_example_batch(config, B=1, cam_hw=(512, 910)))
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
            batch = _to_cuda(_example_batch(config, B=B, cam_hw=(512, 910)))
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
        from __graft_entry__ import _example_batch, _example_targets

        self.batches = []
        for i in range(n):
            targets = _example_targets(config, B=B, seed=10 + seed + i)
            targets["description"] = np.tile(np.array([[0, 0, 0]]), (B, 1))
            self.batches.append((_example_batch(config, B=B,
                                                cam_hw=(512, 910),
                                                seed=seed + i), targets))
        self.batch_size = B

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def phase_serve(config, model):
    """The serving path; returns its launches of both MSDA kernels."""
    from dpft_tpu_torch.evaluation import CentralizedEvaluator
    from dpft_tpu_torch.models import registry
    from dpft_tpu_torch.ops import deform_attn as da

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "run", "2026-01-01-00-00-00_checkpoint_0001.pt")
        registry.save(model, config, ckpt)
        evaluator = CentralizedEvaluator.from_config(config, device="cuda",
                                                     repetitions=REPS)
        dst = os.path.join(tmp, "log")
        da.msda_fwd.launches = da.msda_bwd.launches = 0
        results = evaluator(ckpt, _Loader(config), dst)
        launches = {"msda_fwd": da.msda_fwd.launches,
                    "msda_bwd": da.msda_bwd.launches}
        tree = os.path.join(dst, "2026-01-01-00-00-00", "exports", "kradar")
        files = [os.path.join(d, f) for d, _, fs in os.walk(tree) for f in fs]
        for sub in ("preds", "gts", "desc"):
            if not os.path.isfile(os.path.join(tree, "0.0", "all", sub,
                                               "000001.txt")):
                raise AssertionError(f"exporter wrote no {sub}/000001.txt")
    # 2 batches + warm-up + timed forwards, 4 iterations x 3 views each;
    # serving runs no backward.
    expected = {"msda_fwd": (2 + evaluator.warmup + REPS) * 12,
                "msda_bwd": 0}
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
            print(f"[msda_bwd] camera B={B} f32 one backward: kernel "
                  f"{k_ms:.4f} ms, plain (autograd) {p_ms:.4f} ms")
    return {"name": "msda_bwd", "route": "cuda",
            "source": "dpft_tpu_torch/csrc/msda_bwd.cu",
            "replaces": "dpft_tpu/ops/pallas/deform_attn.py:177",
            "max_abs_err": max_err, "ms": times[0], "plain_ms": times[1]}


def _cuda_batch(config, seed):
    from __graft_entry__ import _example_batch, _example_targets

    return (_to_cuda(_example_batch(config, B=B_TRAIN, cam_hw=(512, 910),
                                    seed=seed)),
            _to_cuda(_example_targets(config, B=B_TRAIN, seed=seed)))


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
    """The train path; returns its launches of both kernels."""
    from dpft_tpu_torch.models import registry
    from dpft_tpu_torch.ops import deform_attn as da
    from dpft_tpu_torch.training import CentralizedTrainer

    config = json.loads(json.dumps(config))
    config["train"]["epochs"] = 2
    train_loader = _Loader(config, B=B_TRAIN, n=4, seed=30)
    val_loader = _Loader(config, B=B_TRAIN, n=2, seed=40)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with tempfile.TemporaryDirectory() as dst:
        trainer = CentralizedTrainer.from_config(config)
        da.msda_fwd.launches = da.msda_bwd.launches = 0
        run = trainer(model, train_loader, val_loader, dst=dst,
                      timestamp="2026-01-01-00-00-00")
        launches = {"msda_fwd": da.msda_fwd.launches,
                    "msda_bwd": da.msda_bwd.launches}
        steps = 2 * len(train_loader.batches)
        val = 2 * len(val_loader.batches)
        expected = {"msda_fwd": CALLS * (steps + val),
                    "msda_bwd": CALLS * steps}
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
        da.msda_fwd.launches = da.msda_bwd.launches = 0
        again = CentralizedTrainer.from_config(config)(
            resumed, train_loader, val_loader, start_epoch=epoch + 1,
            timestamp=timestamp, dst=dst)
        resume_launches = {"msda_fwd": da.msda_fwd.launches,
                           "msda_bwd": da.msda_bwd.launches}
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


def main():
    phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()

    from dpft_tpu_torch.models import registry
    from __graft_entry__ import _example_batch

    with open(os.path.join(ROOT, "config", "kradar.json")) as f:
        config = json.load(f)
    t0 = time.perf_counter()
    model = registry.build(config["model"]["name"], config, device="cuda",
                           seed=0)
    print(f"[flagship] built config/kradar.json on cuda in "
          f"{time.perf_counter() - t0:.1f} s")
    with torch.inference_mode():
        views = model.features(_to_cuda(_example_batch(config, B=1,
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
    fwd_report["launches"] = train_launches["msda_fwd"]
    bwd_report["launches"] = train_launches["msda_bwd"]
    for report in (fwd_report, bwd_report):
        report["launches_by_path"] = {
            "serve": serve_launches[report["name"]],
            "train": train_launches[report["name"]]}
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    print(smi.splitlines()[0] if smi else smi)
    print(json.dumps({"kernels": [fwd_report, bwd_report]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
