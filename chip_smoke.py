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
5. Serve path (the main path): registry.save -> registry.load ->
   CentralizedEvaluator over two synthetic batches -> the K-Radar txt tree.
   Kernel launch counts are reset right before it and read right after.

The last two lines are the kernel report and the result:
    {"kernels": [...]}
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}
"""

import json
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
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
REPS = 20  # timed forwards of the evaluator's latency phase


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


def phase_kernel_vs_plain(view_shapes):
    """Returns the kernel report entry (errors and camera-call times)."""
    from dpft_tpu_torch.ops import deform_attn as da

    cases = [("small_d3", ((6, 9), (3, 5), (2, 3), (1, 601)), 2, 7, 4, 3, 4,
              -0.2, 1.2),
             ("small_d2", ((6, 9), (3, 5), (2, 3)), 2, 7, 4, 2, 4, -0.2, 1.2)]
    for name, shapes in view_shapes.items():
        cases.append((name, shapes, B1, N_QUERIES, HEADS, HEAD_DIM, POINTS,
                      -0.2, 1.2))
    max_err = 0.0
    times = None
    for case, shapes, B, N, H, D, P, lo, hi in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = _msda_inputs(shapes, B, N, H, D, P, dtype, lo, hi, seed=0)
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
    """Two synthetic batches with K-Radar targets, in memory."""

    def __init__(self, config, B=1):
        from __graft_entry__ import _example_batch, _example_targets

        self.batches = []
        for i in range(2):
            targets = _example_targets(config, B=B, seed=10 + i)
            targets["description"] = np.tile(np.array([[0, 0, 0]]), (B, 1))
            self.batches.append((_example_batch(config, B=B,
                                                cam_hw=(512, 910), seed=i),
                                 targets))
        self.batch_size = B

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def phase_serve(config, model):
    """The main path; returns the MSDA kernel launches it made."""
    from dpft_tpu_torch.evaluation import CentralizedEvaluator
    from dpft_tpu_torch.models import registry
    from dpft_tpu_torch.ops import deform_attn as da

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "run", "2026-01-01-00-00-00_checkpoint_0001.pt")
        registry.save(model, config, ckpt)
        evaluator = CentralizedEvaluator.from_config(config, device="cuda",
                                                     repetitions=REPS)
        dst = os.path.join(tmp, "log")
        da.msda_fwd.launches = 0
        results = evaluator(ckpt, _Loader(config), dst)
        launches = da.msda_fwd.launches
        tree = os.path.join(dst, "2026-01-01-00-00-00", "exports", "kradar")
        files = [os.path.join(d, f) for d, _, fs in os.walk(tree) for f in fs]
        for sub in ("preds", "gts", "desc"):
            if not os.path.isfile(os.path.join(tree, "0.0", "all", sub,
                                               "000001.txt")):
                raise AssertionError(f"exporter wrote no {sub}/000001.txt")
    # 2 batches + warm-up + timed forwards, 4 iterations x 3 views each.
    expected = (2 + evaluator.warmup + REPS) * 12
    if launches != expected:
        raise AssertionError(f"the main path launched msda_fwd {launches} "
                             f"times, expected {expected}")
    print(f"[serve] save -> load -> evaluate -> export: {len(files)} files; "
          f"results {json.dumps(results)}; msda_fwd launches {launches}")
    return launches


def main():
    phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()

    from dpft_tpu_torch.models import registry
    from __graft_entry__ import _example_batch

    with open(os.path.join(ROOT, "config", "kradar.json")) as f:
        config = json.load(f)
    config["evaluate"]["metrics"] = {}
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

    report = phase_kernel_vs_plain(view_shapes)
    phase_flagship(config, model)
    report["launches"] = phase_serve(config, model)
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    print(smi.splitlines()[0] if smi else smi)
    print(json.dumps({"kernels": [report]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
