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
   at the small border cases (D = 2, 3), at the flagship level shapes of
   all three views at B=4, N=400, and in a collision case (the points of
   every (b, h) in one cell of each level of the smallest view: on its 2x4
   level 6,400 touches on 4 pixels), and with 900 queries at B=1 (points
   that the value kernel takes in two chunks per block) in the camera view
   and in the collision case: f32 within 1e-4 (sums in another
   order), bf16 against the f32 plain gradient within 5e-2 of its largest
   element. In every case and dtype a second ``msda_bwd`` call and two
   backward passes through ``MSDAFunction`` must give the same bits of
   d_value, d_loc and d_att. The time of one camera-view backward of both.
7. Train step, kernel model vs plain-core model: config/kradar.json at
   B=4 f32, the same weights, batch and dropout seed; the loss within 1e-4
   (relative) and every parameter gradient within 1e-3 of its largest.
   Then one forward of that step and its backward twice (retain_graph): the
   parameters whose gradients differ between the two passes are printed by
   kind of layer, with those of the last decoder iteration's MSDA layers.
8. Train path (the second main path): CentralizedTrainer over 4 synthetic
   B=4 batches for 2 epochs with a 2-batch validation loader, metrics on;
   finite losses, changed parameters, validation metrics, one checkpoint
   per epoch, a resume from the epoch-0 checkpoint, and exact launch
   counts of both kernels (counts reset right before, read right after).
   Expected counts are computed from the model's level shapes.
9. Train step time by CUDA events at B=4 in f32 and bf16 (mean of 10 steps
   after 3 warm-up steps), the host share of matching, peak memory.
10. Matmul-form kernels vs plain: ``msda_mm_fwd`` against the plain level
   op ``sample_level_fused_plain`` and ``msda_mm_bwd`` against
   torch.autograd.grad through it, in float32, at border cases (D = 2, 3,
   4; points on integer coordinates, which must get no coordinate
   gradient; points at +-1e9, which must add exactly 0; and what the
   kernels' 16 x 16 tiles make hard: a level smaller than a tile, h and w
   one off a multiple of the tile, corners -1 and size - 1, all points in
   one tile, all points outside the map, 5000 points; beyond the
   shared-memory limit the wrappers raise and launch nothing)
   and at every flagship level of all three views (forward at B=1,
   backward at B=4, N=400): f32 within 1e-5 / 1e-4 of the largest element
   (sums in another order), bf16 within 2e-2 / 5e-2; ``msda_mm_bwd`` run
   twice gives bit-equal d_val. Then a table of times per level: the mm
   kernels, kernel #1 (``msda_fwd`` / ``msda_bwd``) on that one level,
   ``grid_sample`` times att (the one PyTorch call that computes the level
   op; the port never calls it), the plain version, the bound and the
   operations that the tiled form computes on these inputs; the three are
   first held to compute the same function. The camera's 512x910
   level, which stays in gather form under "mm", is in the table too.
   Then one MSDA call of each view through ``ms_deform_attn_core``: under
   "mm", where the kernels work in place on strided views of one level of
   ``value``, the output and the gradients by autograd are held against
   the plain hybrid core at B=1 and B=4 in float32 (1e-5 / 1e-4 of the
   largest element, d_value of the matmul levels bit-equal twice); the
   grouped launch of all matmul levels of the call is held, bit for bit,
   against the per-level launches (out, d_val, d_x, d_y, d_att) and its
   own coordinates and weights against ``mm_coords_plain``; then both
   backends by CUDA events and by the host's clock.
11. mm model vs default model (run right after phase 7, on the same initial
   weights): config/kradar.json with ``fuser.pallas_msda: "mm"`` set in the
   loaded dict and the default model's weights; the B=1 f32 forward within
   1e-4, one B=4 train step with the loss within 1e-4 (relative) and every
   parameter gradient within 1e-3 of its largest, against the same model
   on the plain hybrid core and against the default model.
12. Serve path under "mm" (the fourth main path): as phase 5 with the mm
   model; ``msda_mm_fwd`` exactly once per view with a level up to the
   cutoff (all its matmul levels in one launch) and ``msda_fwd`` once per
   level above it, per iteration and forward.
13. Train path under "mm" (the fifth main path): CentralizedTrainer for 1
   epoch of 2 B=4 steps and a validation batch, exact counts of all four
   MSDA kernels. Then the times of phases 4 and 9 under "mm"; the train
   step of phase 11 once more on the weights that the train phases have
   updated, each model twice, on its plain core and with the points on exactly integer pixel coordinates taken out of the
   coordinate gradient: there the matmul form's derivative is 0 and the
   gather form's one-sided, so the two forms differ by design (reported,
   not held); and, after every timed phase, the
   kernels, copies and memsets that one forward of the default and of the
   mm model puts on the card, the device time of every MSDA kernel of
   one call per view under both backends, by name (torch.profiler), and
   one call of ``msda_fwd`` and of ``msda_bwd`` per view at B=1 and B=4 in
   f32 and bf16: ms by CUDA events and us on the card by the profiler,
   every kernel, fill and cast of the call summed, beside the bound of the
   call.
14. Radar kernels vs plain: ``radar_reduce_ra`` / ``radar_reduce_ea``
   against ``reduce_tesseract_plain`` on the card at seven small cubes (two
   with a doppler axis that is no multiple of 4, one cropped at 252 range
   bins, one with 37 elevation bins and five doppler bins) and at K-Radar's (64, 256, 37, 107), positive powers from a numpy
   seed, each cube doppler-fastest (the kernels' layout, which loadmat
   gives), C-contiguous (one layout copy in the wrapper) and in float64
   through ``reduce_tesseract`` (cast on the card, bit-equal planes); a
   cube in another layout raises. rtol 3e-4 / atol 3e-2 (float32 sums in
   another order) channel by channel, each channel's typical value printed
   beside its error and required to lie above 30 times atol, with the
   doppler-of-max lookup channel exactly equal; beyond their limits the
   wrappers raise and the launchers refuse; at full size also against the
   numpy transliteration on the host. Times by CUDA events: each kernel in
   both layouts, the layout copy and the cast apart, the plain version, the
   copy of one float32 and one float64 cube to the card from pageable and
   from pinned memory, each beside its bound; after every timed phase the
   device time of each radar kernel, the cast and the layout copy by name
   (torch.profiler).
15. Prepare path (the third main path): a raw K-Radar tree of ten frames
   (eight train, one val, one test) at K-Radar's shapes is written to a
   temporary directory, then
   ``dpft_tpu_torch.prepare.main`` runs on it with config/kradar.json on
   the default device (TF32 set on beforehand, found off afterwards).
   Checked: the twelve files of every frame, the plane
   shapes, ``ra.npy`` / ``ea.npy`` against the plain version, exact launch
   counts (one of each radar kernel per frame, no MSDA launch; counts
   reset right before, read right after), that the processor hands the
   reduction the float64 doppler-fastest cube on the card (no host cast)
   and that one worker holds no more than a float64 and a float32 cube
   there. One split is then read back
   through the port's dataset and loader and run through the flagship
   model. Printed: frames per second, the peak device memory of the run
   (eight workers at once) and the per-frame split: loadmat, copy of the
   float64 cube, cast on the card, kernels, planes back, files; beside it
   the same frame with the cast on the host.

The kernel report gives, for every kernel, its launches on the five main
paths, its error against the plain version, its time, the plain version's,
and ``bound_ms``: the least time the card could take, the larger of the
bytes the function must move (every input read once, every output written
once; for MSDA only the 32-byte sectors of the value map that this run's
sampling points touch) over 3.35 TB/s and its float32 operations over
67 TFLOP/s. For the matmul-form kernels these are the operations of the
function, bilinear sampling of the points, as for kernel #1; the dense
products that the form itself computes are printed apart, in the per-level
lines.
``library_ms`` is ``grid_sample`` times att for the matmul-form kernels
(camera 128x228 level) and null elsewhere: no single PyTorch call computes
multi-level MSDA or either radar plane.

The last two lines are the kernel report and the result:
    {"kernels": [...]}
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}
"""

import json
import math
import os
import re
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
KERNELS = ("msda_fwd", "msda_bwd", "msda_mm_fwd", "msda_mm_bwd",
           "radar_reduce_ra", "radar_reduce_ea")
# Matmul-form border cases (BH, h, w, D, S, placement of the points): odd
# head dims, points on integer coordinates and at +-1e9; and what the 16 x 16
# tiles of csrc/msda_mm.cu make hard: a level smaller than one tile, h and w
# one more and one less than a multiple of the tile, S off the warp (33,
# 131, 150), points whose corner is -1 or size - 1 ("edges"), all points in
# one tile of a level of many, all points outside the map, and more
# candidates per block than one round of the sample list holds (5000).
MM_CASES = ((3, 7, 5, 3, 150, "integer"), (3, 7, 5, 2, 150, "far"),
            (2, 70, 33, 2, 131, "random"), (2, 5, 100, 3, 64, "integer"),
            (2, 2, 3, 2, 33, "random"), (2, 17, 33, 2, 150, "edges"),
            (2, 15, 31, 3, 150, "edges"), (2, 40, 50, 2, 1600, "one_tile"),
            (2, 20, 36, 2, 150, "outside"), (1, 150, 160, 2, 5000, "random"),
            (2, 33, 17, 4, 131, "integer"))

# Published peaks of one H100 SXM: device memory rate and float32 rate
# outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# Radar cubes (doppler, range, elevation, azimuth): small ones with odd and
# even elevation counts and non-power-of-two axes, two whose doppler axis is
# no multiple of 4 (no 16-byte loads; 7 is odd, so no 8-byte loads either,
# and 300 range bins are cropped at 252), one with K-Radar's 37 elevation
# bins (the RA kernel that sorts in registers) and an odd doppler axis, then
# K-Radar's.
KRADAR_CUBE = (64, 256, 37, 107)
RADAR_SHAPES = ((16, 32, 5, 9), (16, 32, 6, 9), (8, 32, 6, 10), (12, 24, 3, 5),
                (6, 40, 4, 3), (7, 300, 3, 5), (5, 12, 37, 2), KRADAR_CUBE)
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
            "msda_mm_fwd": da.msda_mm_fwd, "msda_mm_bwd": da.msda_mm_bwd,
            "radar_reduce_ra": rr.radar_reduce_ra,
            "radar_reduce_ea": rr.radar_reduce_ea}


def _reset_launches():
    for wrapper in _kernel_wrappers().values():
        wrapper.launches = 0


def _read_launches():
    return {name: w.launches for name, w in _kernel_wrappers().items()}


def _expected_launches(config, view_shapes, forwards, steps):
    """Launches of every kernel over ``forwards`` model forwards of which
    ``steps`` are followed by a backward, from the model's level shapes:
    under "mm" one ``msda_mm_*`` launch per view that has a level up to the
    cutoff (all its matmul levels go in one launch) and one of kernel #1
    per level above it, per fusion iteration; else one launch of kernel #1
    per view and iteration."""
    from dpft_tpu_torch.models.fusers.mpfusion import msda_backend_from_config
    from dpft_tpu_torch.ops.deform_attn import MM_MAX_LEVELS, _MATMUL_MAX_HW

    fuser = config["model"]["fuser"]
    if msda_backend_from_config(fuser) == "mm":
        per_view = [sum(h + w <= _MATMUL_MAX_HW for h, w in shapes)
                    for shapes in view_shapes.values()]
        mm = sum(-(-n // MM_MAX_LEVELS) for n in per_view)
        gather = sum(map(len, view_shapes.values())) - sum(per_view)
    else:
        mm, gather = 0, len(view_shapes)
    per = {"msda_fwd": (gather, forwards), "msda_bwd": (gather, steps),
           "msda_mm_fwd": (mm, forwards), "msda_mm_bwd": (mm, steps)}
    expected = dict.fromkeys(KERNELS, 0)
    expected.update({k: fuser["i_iter"] * n * times
                     for k, (n, times) in per.items()})
    return expected


def _plain_core(value, shapes, loc, att, backend="gather"):
    """The plain PyTorch version of the layer's MSDA core."""
    from dpft_tpu_torch.ops import deform_attn as da

    plain = (da.ms_deform_attn_core_mm_plain if backend == "mm"
             else da.ms_deform_attn_core_plain)
    return plain(value, shapes, loc, att)


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
    lib = kernels.library()
    seconds = time.perf_counter() - t0
    from dpft_tpu_torch.ops import deform_attn as da
    if lib.dpft_msda_mm_tile() != da.MM_TILE:
        raise AssertionError(f"csrc/msda_mm.cu tiles by "
                             f"{lib.dpft_msda_mm_tile()}, the wrappers by "
                             f"{da.MM_TILE}")
    print(f"[build] {os.path.relpath(info.path, ROOT)} in {seconds:.2f} s "
          f"(nvcc {info.seconds:.2f} s)")
    # ptxas names each function (mangled) before its spills and registers.
    name = "?"
    for line in info.log.splitlines():
        if "Function properties for" in line:
            name = _kernel_name(line.split()[-1])
        elif "registers" in line or "spill" in line:
            print(f"[build]   {name}: {line.strip()}")


def _kernel_name(mangled):
    """``msda_bwd_value_kernelIfLi2EE`` of a mangled name: the identifier
    that ends in ``_kernel`` (mangled names prefix each one with its
    length) and its template arguments, still mangled."""
    for m in re.finditer(r"\d+", mangled):
        for k in range(m.start(), m.end()):  # a hash may run into the length
            ident = mangled[m.end():m.end() + int(mangled[k:m.end()])]
            if ident.endswith("_kernel") and ident.isidentifier():
                args = re.match(r"I\w*?EE", mangled[m.end() + len(ident):])
                return ident + (args.group() if args else "")
    return mangled


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
        msda_layer.ms_deform_attn_core = _plain_core
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
    _time_forwards(config, model, "flagship")


def _time_forwards(config, model, label):
    """Latency (CUDA events) and peak memory of the forward at B=1 and B=4
    in f32 and bf16. The peak counts whatever else is held on the card."""
    from dpft_tpu_torch.utils.example import example_batch

    held = torch.cuda.memory_allocated() / 2 ** 30
    model.eval()
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
            print(f"[{label}] B={B} {str(dtype)[6:]}: {ms:.3f} ms/batch, "
                  f"{ms / B:.3f} ms/frame, peak memory {peak:.3f} GiB "
                  f"({held:.3f} GiB held before)")
    model.compute_dtype = torch.float32


def phase_launch_counts(config, models):
    """Kernels, copies and memsets that one forward puts on the card, for
    each of ``models`` (label -> model), counted by torch.profiler. It runs
    after every timed phase: once the profiler has been used, its tracing
    stays attached and every later launch costs the host more."""
    from torch.profiler import ProfilerActivity, profile

    from dpft_tpu_torch.utils.example import example_batch

    for dtype in (torch.float32, torch.bfloat16):
        for B in (1, 4):
            batch = _to_cuda(example_batch(config, B=B, cam_hw=(512, 910)))
            counts = {}
            for label, model in models.items():
                model.eval()
                model.compute_dtype = dtype
                with torch.inference_mode():
                    model(batch)
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        model(batch)
                        torch.cuda.synchronize()
                model.compute_dtype = torch.float32
                n = sum(e.device_type == torch.autograd.DeviceType.CUDA
                        for e in prof.events())
                counts[label] = n or "not measured"
            print(f"[launches] B={B} {str(dtype)[6:]}: device launches per "
                  f"forward {counts}")


def phase_kernel_times(view_shapes):
    """Device time of every kernel that one MSDA call (forward + backward)
    of each view launches, under both backends, by name (torch.profiler,
    mean of 10 calls). Runs after every timed phase, as
    ``phase_launch_counts`` does."""
    from torch.profiler import ProfilerActivity, profile

    from dpft_tpu_torch.ops import deform_attn as da

    for view, shapes in view_shapes.items():
        for B in (B1, B_TRAIN):
            value, loc, att = _msda_inputs(shapes, B, N_QUERIES, HEADS,
                                           HEAD_DIM, POINTS, torch.float32,
                                           -0.2, 1.2, seed=5)
            grad = torch.randn(B, N_QUERIES, HEADS * HEAD_DIM, device="cuda")
            leaves = [t.detach().requires_grad_(True)
                      for t in (value, loc, att)]
            for backend in da.BACKENDS:
                def both():
                    out = da.ms_deform_attn_core(leaves[0], shapes,
                                                 *leaves[1:], backend=backend)
                    torch.autograd.grad(out, leaves, grad)

                both()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        both()
                    torch.cuda.synchronize()
                cells = []
                for event in prof.key_averages():
                    if "msda" in event.key and event.device_time_total > 0:
                        name = event.key[event.key.find("msda"):].split("(")[0]
                        cells.append(f"{name} "
                                     f"{event.device_time_total / event.count:.1f}")
                print(f"[kernel times] {view} B={B} f32 {backend}, us per "
                      f"launch: {', '.join(sorted(cells)) or 'not measured'}")


def _device_us(fn, reps=10):
    """Time of one call of ``fn`` on the card in us by torch.profiler (mean
    of ``reps`` calls): how long at least one kernel, fill or copy that it
    puts on the card was running (work on two streams at once counts once),
    and each one's own time by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names, spans = {}, []
    for event in prof.events():
        if event.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = (event.time_range.start, event.time_range.end)
        spans.append(span)
        key = event.name
        name = (key[key.find("msda"):] if "msda" in key
                else key).split("<")[0].split("(")[0][:40]
        names[name] = names.get(name, 0.0) + (span[1] - span[0]) / reps
    busy, end = 0.0, -math.inf
    for start, stop in sorted(spans):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy / reps, names


def phase_msda_call_times(view_shapes):
    """One MSDA call of each view through ``msda_fwd`` and ``msda_bwd`` at
    B=1 and B=4: ms by CUDA events and the card's own time by the profiler,
    the backward's fills and casts included, beside the bound of the call
    (forward: sampled value sectors, locations, weights read once and the
    output written once, or 10 operations per corner and channel; backward:
    those and grad_out read once, d_value written whole, d_loc and d_att
    written once, or 30 operations per corner and channel). Events first:
    the profiler runs after every timed phase, as ``phase_kernel_times``."""
    from dpft_tpu_torch.ops import deform_attn as da

    cells = {}
    for view, shapes in view_shapes.items():
        for B in (B1, B_TRAIN):
            value, loc, att = _msda_inputs(shapes, B, N_QUERIES, HEADS,
                                           HEAD_DIM, POINTS, torch.float32,
                                           -0.2, 1.2, seed=6)
            grad = torch.randn(B, N_QUERIES, HEADS * HEAD_DIM, device="cuda",
                               generator=torch.Generator("cuda").manual_seed(7))
            sampled = _msda_value_bytes(value, shapes, loc)
            out_bytes = B * N_QUERIES * HEADS * HEAD_DIM * 4
            corners = 4 * att.numel() * HEAD_DIM
            bounds = (_bound(sampled + _nbytes(loc, att) + out_bytes,
                             10 * corners),
                      _bound(sampled + 2 * _nbytes(loc, att) + out_bytes
                             + _nbytes(value), 30 * corners))
            calls = {}
            for dtype in (torch.float32, torch.bfloat16):
                args = (value.to(dtype), shapes, loc, att.to(dtype))
                g = grad.to(dtype)
                calls["fwd", dtype] = lambda args=args: da.msda_fwd(*args)
                calls["bwd", dtype] = lambda args=args, g=g: da.msda_bwd(
                    *args, g)
            with torch.inference_mode():
                events = {k: _cuda_ms(fn, reps=50) for k, fn in calls.items()}
            cells[view, B] = (calls, events, bounds)
    for (view, B), (calls, events, bounds) in cells.items():
        parts = []
        for (what, dtype), fn in calls.items():
            with torch.inference_mode():
                us, names = _device_us(fn)
            split = ", ".join(f"{n} {t:.1f}" for n, t in sorted(names.items()))
            parts.append(f"{what} {str(dtype)[6:]} {events[what, dtype]:.4f} "
                         f"ms by events, {us:.1f} us on the card ({split})")
        (f_ms, f_by), (b_ms, b_by) = bounds
        print(f"[msda calls] {view} B={B}: {'; '.join(parts)}; bound (f32) "
              f"fwd {1e3 * f_ms:.2f} us ({f_by}), bwd {1e3 * b_ms:.2f} us "
              f"({b_by})")


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


def phase_serve(config, model, view_shapes, label="serve"):
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
    # 2 batches + warm-up + timed forwards; serving runs no backward and
    # reduces no radar cube.
    expected = _expected_launches(config, view_shapes,
                                  2 + evaluator.warmup + REPS, 0)
    if launches != expected:
        raise AssertionError(f"the {label} path launched {launches}, "
                             f"expected {expected}")
    print(f"[{label}] save -> load -> evaluate -> export: {len(files)} files; "
          f"results {json.dumps(results)}; launches {launches}")
    return launches


def _plain_grads(value, shapes, loc, att, grad_out):
    from dpft_tpu_torch.ops import deform_attn as da

    inputs = [t.detach().float().requires_grad_(True)
              for t in (value, loc, att)]
    out = da.ms_deform_attn_core_plain(inputs[0], shapes, *inputs[1:])
    return torch.autograd.grad(out, inputs, grad_out.float())


def _same_bits_twice(what, args, got):
    """``msda_bwd`` on ``args`` once more, and the gradients of
    ``MSDAFunction`` twice by autograd, must give the bits of ``got``."""
    from dpft_tpu_torch.ops import deform_attn as da

    value, shapes, loc, att, grad_out = args
    runs = {"msda_bwd again": da.msda_bwd(*args)}
    for k in ("once", "twice"):
        leaves = [t.detach().requires_grad_(True) for t in (value, loc, att)]
        out = da.ms_deform_attn_core(leaves[0], shapes, *leaves[1:])
        runs[f"MSDAFunction {k}"] = torch.autograd.grad(out, leaves, grad_out)
    for run, grads in runs.items():
        for name, a, b in zip(("d_value", "d_loc", "d_att"), got, grads):
            if not torch.equal(a, b):
                raise AssertionError(f"msda_bwd {what}: {name} of {run} "
                                     "differs from the first call's bits")


def phase_bwd_vs_plain(view_shapes):
    """Returns the kernel report entry of msda_bwd."""
    from dpft_tpu_torch.ops import deform_attn as da

    max_err = 0.0
    times = None
    # The collision case: the points of every (b, h) on few pixels of each
    # level (2 x 2 of the smallest view's 2x4 level), for one call.
    small = min(view_shapes.values(), key=lambda s: sum(h * w for h, w in s))
    cases = [(*case, (-0.2, 1.2)) for case in _msda_cases(view_shapes,
                                                          B_TRAIN)]
    cases.append(("collide", small, B_TRAIN, N_QUERIES, HEADS, HEAD_DIM,
                  POINTS, (0.45, 0.55)))
    # 900 queries (as DETR-style decoders take): 3,600 points per (b, h,
    # level), which the value kernel takes in two chunks.
    large = max(view_shapes.values(), key=lambda s: sum(h * w for h, w in s))
    cases.append(("camera_900q", large, 1, 900, HEADS, HEAD_DIM, POINTS,
                  (-0.2, 1.2)))
    cases.append(("collide_900q", small, 1, 900, HEADS, HEAD_DIM, POINTS,
                  (0.45, 0.55)))
    for case, shapes, B, N, H, D, P, (lo, hi) in cases:
        value, loc, att = _msda_inputs(shapes, B, N, H, D, P, torch.float32,
                                       lo, hi, seed=1)
        grad_out = torch.randn(B, N, H * D, device="cuda",
                               generator=torch.Generator("cuda").manual_seed(2))
        want = _plain_grads(value, shapes, loc, att, grad_out)
        for dtype in (torch.float32, torch.bfloat16):
            args = (value.to(dtype), shapes, loc, att.to(dtype),
                    grad_out.to(dtype))
            got = da.msda_bwd(*args)
            _same_bits_twice(f"{case} {str(dtype)[6:]}", args, got)
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
                  f"{' '.join(errs)} (tol {BWD_TOL[dtype]}); the same bits "
                  "again and twice through MSDAFunction, ok")
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


def _step_loss_and_grads(trainer, model, batch, targets):
    model.zero_grad(set_to_none=True)
    torch.manual_seed(3)  # the same dropout masks
    loss = trainer.train_step(model, batch, targets)["loss"]
    grads = {k: p.grad.clone() for k, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss, grads


def _compare_steps(what, against, step, ref_step, tol=1e-3):
    """Holds one train step against a reference step: the loss within 1e-4
    (relative), every parameter gradient within ``tol`` of its largest
    (``tol=None``: the gradients are only reported)."""
    (loss, grads), (ref_loss, ref_grads) = step, ref_step
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    if not (math.isfinite(loss) and loss_err <= 1e-4):
        raise AssertionError(f"train step loss {loss} vs {against} "
                             f"{ref_loss}: relative err {loss_err:.3e}")
    if set(grads) != set(ref_grads):
        raise AssertionError(f"{what} and {against} steps reach different "
                             "parameters")
    worst = (0.0, "")
    for k, g in grads.items():
        ref = ref_grads[k]
        err = ((g - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()
        worst = max(worst, (err, k))
    if not (math.isfinite(worst[0]) and (tol is None or worst[0] <= tol)):
        raise AssertionError(f"{what} vs {against}: gradient of {worst[1]}: "
                             f"err {worst[0]:.3e} of its max exceeds {tol}")
    held = "reported, not held" if tol is None else f"tol {tol}"
    print(f"[train] B={B_TRAIN} f32 step, {what} vs {against}: "
          f"loss {loss:.6f} vs {ref_loss:.6f} (rel err {loss_err:.3e}, tol "
          f"1e-4); {len(grads)} gradients, worst {worst[0]:.3e} of its max "
          f"at {worst[1]} ({held}) ok")


def phase_train_step_vs_plain(config, model):
    """One train step of the kernel model against the plain-core model."""
    import dpft_tpu_torch.models.layers.ms_deform_attn as msda_layer
    from dpft_tpu_torch.ops import deform_attn as da
    from dpft_tpu_torch.training import CentralizedTrainer

    trainer = CentralizedTrainer.from_config(config)
    batch, targets = _cuda_batch(config, seed=20)
    step = _step_loss_and_grads(trainer, model, batch, targets)
    msda_layer.ms_deform_attn_core = _plain_core
    try:
        ref_step = _step_loss_and_grads(trainer, model, batch, targets)
    finally:
        msda_layer.ms_deform_attn_core = da.ms_deform_attn_core
    _compare_steps("kernel model", "plain-core model", step, ref_step)


def phase_step_backward_twice(config, model):
    """One flagship train step's forward at B=4 f32, then its backward twice
    (``retain_graph``): prints every parameter whose gradient differs
    between the two passes, by kind of layer, and which of the MSDA layers
    of the last decoder iteration (``value_proj``, ``sampling_offsets``,
    ``attention_weights``, ``output_proj``) do. Reported, not held: the
    kernels' own bits are held in phase 6."""
    from dpft_tpu_torch.training import CentralizedTrainer

    trainer = CentralizedTrainer.from_config(config)
    batch, targets = _cuda_batch(config, seed=20)
    model.train()
    torch.manual_seed(3)
    out = model(batch)
    total, _ = trainer.loss_fn(out, targets,
                               indices=trainer.loss_fn.match(out, targets))
    names, params = zip(*((k, p) for k, p in model.named_parameters()
                          if p.requires_grad))
    first = torch.autograd.grad(total, params, retain_graph=True,
                                allow_unused=True)
    second = torch.autograd.grad(total, params, allow_unused=True)
    differ = {}
    for name, a, b in zip(names, first, second):
        if a is not None and not torch.equal(a, b):
            differ[name] = ((a - b).abs().max()
                            / a.abs().max().clamp_min(1e-30)).item()
    last = "fusion%d" % max(int(m[1]) for k in names
                            if (m := re.match(r"fuser\.mpfusion\.fusion(\d+)",
                                              k)))
    held = [k for k in names if f".{last}." in k and ".ms_deform_attn." in k]
    if not held:
        raise AssertionError(f"no MSDA parameters in {last}")
    groups = {}  # one line per kind of layer: iterations and views merged
    for name in differ:
        group = re.sub(r"(fusion|ms_deform_attn)\d+", r"\1*", name)
        group = re.sub(r"\.(\d+)\.", ".*.", group.rsplit(".", 1)[0])
        groups.setdefault(group, []).append(name)
    moved = [k for k in held if k in differ]
    print(f"[train] B={B_TRAIN} f32 step, backward twice on one forward: "
          f"{len(differ)} of {len(names)} parameter gradients differ; of the "
          f"{len(held)} MSDA parameters of {last}, {len(moved)} differ "
          f"{moved}")
    for group, members in sorted(groups.items()):
        worst = max(differ[k] for k in members)
        print(f"[train]   differ: {group}: {len(members)} parameters, worst "
              f"{worst:.3e} of its max ({members[0]}, ...)")
    model.zero_grad(set_to_none=True)


def phase_train(config, model, view_shapes, label="train", epochs=2,
                n_train=4, n_val=2, resume=True):
    """The train path; returns its launches of every kernel."""
    from dpft_tpu_torch.models import registry
    from dpft_tpu_torch.training import CentralizedTrainer

    config = json.loads(json.dumps(config))
    config["train"]["epochs"] = epochs
    train_loader = _Loader(config, B=B_TRAIN, n=n_train, seed=30)
    val_loader = _Loader(config, B=B_TRAIN, n=n_val, seed=40)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with tempfile.TemporaryDirectory() as dst:
        trainer = CentralizedTrainer.from_config(config)
        _reset_launches()
        run = trainer(model, train_loader, val_loader, dst=dst,
                      timestamp="2026-01-01-00-00-00")
        launches = _read_launches()
        steps = epochs * n_train
        val = epochs * n_val
        expected = _expected_launches(config, view_shapes, steps + val, steps)
        if launches != expected:
            raise AssertionError(f"the {label} path launched {launches}, "
                                 f"expected {expected}")
        with open(os.path.join(dst, run["timestamp"], "scalars.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        losses = [r["loss"] for r in rows]
        if not (all(map(math.isfinite, losses)) and len(rows) == 2 * epochs):
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
                 for e in range(epochs)]
        if not all(map(os.path.isfile, ckpts)):
            raise AssertionError(f"missing checkpoints: {ckpts}")
        print(f"[{label}] CentralizedTrainer {epochs} epochs x {n_train} "
              f"steps + {n_val} val batches, B={B_TRAIN} f32: losses "
              f"{[round(x, 4) for x in losses]}; val {json.dumps(run['result'])}"
              f"; {changed} state tensors changed; checkpoints written; "
              f"launches {launches}")
        if not resume:
            return launches

        # Resume from the epoch-0 checkpoint: one more epoch.
        resumed, _, epoch, timestamp = registry.load(ckpts[0], config,
                                                     "cuda")
        _reset_launches()
        again = CentralizedTrainer.from_config(config)(
            resumed, train_loader, val_loader, start_epoch=epoch + 1,
            timestamp=timestamp, dst=dst)
        resume_launches = _read_launches()
        want = {k: v // epochs for k, v in expected.items()}
        if resume_launches != want or len(again["history"]) != 1:
            raise AssertionError(f"resume launched {resume_launches} over "
                                 f"{len(again['history'])} epochs, expected "
                                 f"{want} over 1")
        print(f"[train] resumed from epoch 0 under {timestamp}: 1 epoch, "
              f"loss {again['history'][0]:.4f}, launches {resume_launches}")
        del resumed
    return launches


def phase_train_timing(config, model, label="train"):
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
        print(f"[{label}] B={B_TRAIN} {str(dtype)[6:]} step (forward, matching,"
              f" loss, metric, backward, AdamW): {np.mean(times):.3f} ms "
              f"(std {np.std(times):.3f}, 10 steps by CUDA events); matching "
              f"on the host {1e3 * np.mean(host[-10:]):.3f} ms = "
              f"{100 * share:.1f}% of the step; peak memory {peak:.3f} GiB")
    model.compute_dtype = torch.float32


def _mm_level_inputs(BH, h, w, D, S, dtype, seed, case="random"):
    """One level's val, x, y, att and grad_out on the card from a numpy
    seed, and the normalized locations (2, BH, S) that x and y come from:
    x = loc_x * w - 0.5 in float32, as the model computes it."""
    rng = np.random.default_rng(seed)
    val = torch.tensor(rng.normal(size=(BH, h, w * D)), dtype=dtype,
                       device="cuda")
    loc = rng.uniform(-0.2, 1.2, size=(2, BH, S)).astype(np.float32)
    if case == "integer":
        # A third of the points on integer x, another third on integer y,
        # from the border line -1 to the border line size.
        loc[0, :, ::3] = (rng.integers(-1, w + 1, size=loc[0, :, ::3].shape)
                          + 0.5) / w
        loc[1, :, 1::3] = (rng.integers(-1, h + 1, size=loc[1, :, 1::3].shape)
                           + 0.5) / h
    loc = torch.from_numpy(loc).cuda()
    x, y = loc[0] * w - 0.5, loc[1] * h - 0.5
    if case == "integer" and not ((x == x.round()).any()
                                  and (y == y.round()).any()):
        raise AssertionError("no point on an integer coordinate")
    if case == "far":
        x[:, :5], y[:, 3:9] = 1e9, -1e9
    elif case == "edges":
        # Corners -1 and size - 1 (the halo row and column of the border
        # tiles), and the lines -1, 0, size - 1 and size themselves.
        x[:, 0::8] = -1.0 + x[:, 0::8].abs() % 1
        x[:, 1::8] = w - 1.0 + x[:, 1::8].abs() % 1
        y[:, 2::8] = -1.0 + y[:, 2::8].abs() % 1
        y[:, 3::8] = h - 1.0 + y[:, 3::8].abs() % 1
        x[:, 4:44:8] = torch.tensor([-1.0, 0.0, w - 1.0, w, 15.0],
                                    device="cuda")
        y[:, 5:45:8] = torch.tensor([-1.0, 0.0, h - 1.0, h, 16.0],
                                    device="cuda")
    elif case == "one_tile":
        # Every corner in the tile of rows and columns 16 .. 31.
        x, y = 16 + x.abs() % 15.9, 16 + y.abs() % 15.9
    elif case == "outside":
        x[:, 0::2] = -1.0 - x[:, 0::2].abs()
        y[:, 1::2] = h + y[:, 1::2].abs()
    att = torch.tensor(rng.uniform(size=(BH, S)), dtype=dtype, device="cuda")
    grad = torch.tensor(rng.normal(size=(BH, S, D)), dtype=dtype,
                        device="cuda")
    return (val, x.contiguous(), y.contiguous(), att, grad), loc


def _plain_level(val, x, y, att, grad, h, w):
    """The plain level op in float32 and its gradients by autograd."""
    from dpft_tpu_torch.ops import deform_attn as da

    args = [t.detach().float().requires_grad_(True)
            for t in (val, x, y, att)]
    out = da.sample_level_fused_plain(*args, h, w)
    return out.detach(), torch.autograd.grad(out, args, grad.float())


def _hold(what, got, want, tol):
    """max abs err of ``got`` against ``want``, held to ``tol`` times the
    largest element of ``want``."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    err = (got.float() - want).abs().max().item()
    scale = want.abs().max().item()
    if not err <= tol * scale:
        raise AssertionError(f"{what}: max abs err {err:.3e} exceeds {tol} "
                             f"of the largest element {scale:.3e}")
    return err


def _mm_check(what, inputs, h, w, backward):
    """``msda_mm_fwd`` (and ``msda_mm_bwd``, run twice) against the plain
    level op in float32; returns the float32-relevant max abs errs."""
    from dpft_tpu_torch.ops import deform_attn as da

    val, x, y, att, grad = inputs
    dtype = val.dtype
    want, want_grads = _plain_level(*inputs, h, w)
    out = da.msda_mm_fwd(val, x, y, att, h, w)
    torch.cuda.synchronize()
    if out.dtype != dtype:
        raise AssertionError(f"{what}: out is {out.dtype}")
    errs = [_hold(f"msda_mm_fwd {what}", out, want, TOL[dtype])]
    if backward:
        got = da.msda_mm_bwd(val, x, y, att, grad, h, w)
        again = da.msda_mm_bwd(val, x, y, att, grad, h, w)
        torch.cuda.synchronize()
        if not torch.equal(got[0], again[0]):
            raise AssertionError(f"msda_mm_bwd {what}: d_val differs between "
                                 "two runs on the same inputs")
        for name, g, wg in zip(("d_val", "d_x", "d_y", "d_att"), got,
                               want_grads):
            if g.dtype != (torch.float32 if name in ("d_x", "d_y")
                           else dtype):
                raise AssertionError(f"msda_mm_bwd {what} {name}: {g.dtype}")
            errs.append(_hold(f"msda_mm_bwd {what} {name}", g,
                              wg.reshape(g.shape), BWD_TOL[dtype]))
    return errs


def _mm_bounds(BH, h, w, D, S, x, y, itemsize=4):
    """Bounds of one level's op, forward and backward: ``(bound, tiled_ms)``
    each. The bound is what the function needs, whatever form computes it:
    val, x, y, att and the output moved once (backward: also grad_out,
    d_val, d_x, d_y, d_att), or the sampling operations, 10 per corner and
    channel forward and 30 backward as for kernel #1. ``tiled_ms`` is the
    floor of the tiled matmul form's own design, not of the function: the
    float32 operations of the small products it computes on these inputs,
    at the card's peak rate. Per channel and sample inside the map the
    forward multiplies the 9 x 9 values around the corner (a quarter of a
    tile and its halo) by Ay and the 9 sums by Ax; the backward does that
    with Ay and Ay' and three row sums, and adds a 16 x 16 block of
    Ay^T d_tmp for every tile of d_val that a sample of this run touches."""
    from dpft_tpu_torch.ops import deform_attn as da

    small = BH * S * (2 * 4 + itemsize)            # x, y, att
    plane = BH * h * w * D * itemsize
    out = BH * S * D * itemsize
    corners = 4 * BH * S * D
    win = da.MM_TILE // 2 + 1
    n_tr, n_tc = da.mm_tile_counts(h, w)
    inside = int((da.mm_bin_index(x, y, h, w) < n_tr * n_tc).sum())
    fwd_ops = inside * D * (2 * win * win + 2 * win)
    rows = sum(da.mm_touches(y, r * da.MM_TILE).long() for r in range(n_tr))
    cols = sum(da.mm_touches(x, c * da.MM_TILE).long() for c in range(n_tc))
    touched = int((rows * cols).sum())             # (sample, d_val tile) pairs
    bwd_ops = (inside * D * (4 * win * win + 8 * win)
               + touched * 2 * da.MM_TILE ** 2 * D)
    return ((_bound(plane + small + out, 10 * corners),
             1e3 * fwd_ops / PEAK_F32_FLOPS),
            (_bound(2 * plane + 2 * small + out, 30 * corners),
             1e3 * bwd_ops / PEAK_F32_FLOPS))


def _one_level_msda(inputs, loc, h, w, B):
    """The same level and points in the layout of kernel #1: value
    (B, h*w, H, D), loc (B, N, H, 1, P, 2), att (B, N, H, 1, P), grad_out
    (B, N, H*D) (one gradient per query, so the sum over points is part of
    it)."""
    val, _, _, att, grad = inputs
    H, N, P = HEADS, N_QUERIES, POINTS
    D = val.shape[-1] // w
    value = val.view(B, H, h * w, D).permute(0, 2, 1, 3).contiguous()
    loc = loc.view(2, B, H, N, P).permute(1, 3, 2, 4, 0).unsqueeze(
        3).contiguous()
    att = att.view(B, H, N, P).permute(0, 2, 1, 3).unsqueeze(3).contiguous()
    grad = grad.view(B, H, N, P, D)[:, :, :, 0].permute(
        0, 2, 1, 3).reshape(B, N, H * D).contiguous()
    return value, loc, att, grad


def _grid_sample_level(val, loc, att, h, w):
    """``grid_sample`` (bilinear, zeros, align_corners=False) times att: the
    one PyTorch call that computes the level op. Timed only."""
    BH, S = att.shape
    D = val.shape[-1] // w
    image = val.view(BH, h, w, D).permute(0, 3, 1, 2)
    grid = (2.0 * loc - 1.0).permute(1, 2, 0).unsqueeze(2)   # (BH, S, 1, 2)
    out = torch.nn.functional.grid_sample(
        image, grid.to(val.dtype), mode="bilinear", padding_mode="zeros",
        align_corners=False)                                 # (BH, D, S, 1)
    return out[..., 0].transpose(1, 2) * att[..., None]


def _check_mm_limits(da):
    """Beyond the kernels' limits a CUDA level raises and launches
    nothing: 289 values of heads * D = 256 floats are 296 KB of shared
    memory."""
    inputs, _ = _mm_level_inputs(1, 3, 4, 256, 40, torch.float32, seed=3)
    for wrapper, args in ((da.msda_mm_fwd, inputs[:4]),
                          (da.msda_mm_bwd, inputs)):
        before = wrapper.launches
        try:
            wrapper(*args, 3, 4)
        except RuntimeError as exc:
            if "limits" not in str(exc) or wrapper.launches != before:
                raise
        else:
            raise AssertionError(f"{wrapper.__name__} accepted D = 256, "
                                 "beyond its shared-memory limit")
    print("[msda_mm] beyond the shared-memory limit both wrappers raise, "
          "naming the limits, and launch nothing, ok")


def phase_mm_vs_plain(view_shapes):
    """The matmul-form kernels against the plain level op, and the
    per-level table. Returns the reports of msda_mm_fwd and msda_mm_bwd."""
    from dpft_tpu_torch.ops import deform_attn as da

    H, D, S = HEADS, HEAD_DIM, N_QUERIES * POINTS
    max_err = {"fwd": 0.0, "bwd": 0.0}

    def note(errs, dtype):
        if dtype == torch.float32:
            max_err["fwd"] = max(max_err["fwd"], errs[0])
            max_err["bwd"] = max([max_err["bwd"], *errs[1:]])

    for BH, h, w, d, s, case in MM_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            inputs, _ = _mm_level_inputs(BH, h, w, d, s, dtype, seed=3,
                                         case=case)
            errs = _mm_check(f"{h}x{w} D={d} S={s} {case}", inputs, h, w,
                             backward=True)
            note(errs, dtype)
            print(f"[msda_mm] BH={BH} {h}x{w} D={d} S={s} {case} "
                  f"{str(dtype)[6:]}: max_abs_err out={errs[0]:.3e} "
                  f"d_val={errs[1]:.3e} d_x={errs[2]:.3e} d_y={errs[3]:.3e} "
                  f"d_att={errs[4]:.3e} (tol {TOL[dtype]} / {BWD_TOL[dtype]} "
                  "of the largest element), d_val bit-equal twice, ok")
    # Points on integer coordinates and far outside: no coordinate gradient.
    inputs, _ = _mm_level_inputs(3, 7, 5, 3, 150, torch.float32, 3, "integer")
    _, d_x, d_y, _ = da.msda_mm_bwd(*inputs, 7, 5)
    if (d_x[inputs[1] == inputs[1].round()] != 0).any() or \
            (d_y[inputs[2] == inputs[2].round()] != 0).any():
        raise AssertionError("msda_mm_bwd: a point on an integer coordinate "
                             "got a coordinate gradient")
    inputs, _ = _mm_level_inputs(3, 7, 5, 2, 150, torch.float32, 3, "far")
    far = (inputs[1].abs() > 1e8) | (inputs[2].abs() > 1e8)
    out = da.msda_mm_fwd(*inputs[:4], 7, 5)
    grads = da.msda_mm_bwd(*inputs, 7, 5)
    if any((t[far] != 0).any() for t in (out, *grads[1:])):
        raise AssertionError("msda_mm: a point at +-1e9 added something")
    # The differentiable op: autograd reaches both kernels.
    args = [t.detach().requires_grad_(True) for t in inputs[:4]]
    before = (da.msda_mm_fwd.launches, da.msda_mm_bwd.launches)
    got = torch.autograd.grad(da.sample_level_fused(*args, 7, 5), args,
                              inputs[4])
    if (da.msda_mm_fwd.launches, da.msda_mm_bwd.launches) != (
            before[0] + 1, before[1] + 1):
        raise AssertionError("sample_level_fused did not launch the kernels")
    for g, wg in zip(got, grads):
        if not torch.equal(g, wg):
            raise AssertionError("sample_level_fused: autograd differs from "
                                 "msda_mm_bwd")
    print("[msda_mm] integer coordinates give d_x = d_y = 0, points at "
          "+-1e9 give exactly 0 and gradient 0, sample_level_fused reaches "
          "both kernels through autograd, ok")
    _check_mm_limits(da)

    # Every flagship level of all three views: forward at B=1, backward at
    # B=4, float32 and bfloat16; then the times, float32. The camera's
    # 512x910 level, which the cutoff keeps in gather form, is included.
    reports = {}
    print("[levels] per level, f32, ms by CUDA events (forward B=1 / "
          f"backward B={B_TRAIN}): mm = msda_mm_fwd / msda_mm_bwd; k1 = "
          "msda_fwd / msda_bwd on that one level; lib = grid_sample x att "
          "and autograd through it; bound of the level op (bytes moved once "
          "or its sampling operations); tiled = the operations that the "
          "tiled matmul form computes on these inputs (9 x 9 products per "
          "channel and sample inside the map, 16 x 16 per touched d_val "
          "tile) at the card's float32 peak")
    for view, shapes in view_shapes.items():
        for h, w in shapes:
            cells = {}
            for B, backward in ((B1, False), (B_TRAIN, True)):
                for dtype in (torch.float32, torch.bfloat16):
                    inputs, loc = _mm_level_inputs(B * H, h, w, D, S, dtype,
                                                   seed=4)
                    errs = _mm_check(f"{view} {h}x{w} B={B}", inputs, h, w,
                                     backward)
                    note(errs, dtype)
                    cells[B, dtype] = errs
                # Times in float32, on the inputs of the last float32 check.
                inputs, loc = _mm_level_inputs(B * H, h, w, D, S,
                                               torch.float32, seed=4)
                val, x, y, att, grad = inputs
                k1 = _one_level_msda(inputs, loc, h, w, B)
                with torch.inference_mode():
                    # The three compute the same function of these inputs.
                    same = da.msda_mm_fwd(val, x, y, att, h, w)
                    lib = _grid_sample_level(val, loc, att, h, w)
                    one = da.msda_fwd(k1[0], ((h, w),), k1[1], k1[2])
                    summed = same.view(B, H, N_QUERIES, POINTS, D).sum(
                        3).permute(0, 2, 1, 3).reshape(B, N_QUERIES, H * D)
                    for name, a, b in (("grid_sample", lib, same),
                                       ("msda_fwd", one, summed)):
                        if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
                            raise AssertionError(
                                f"{view} {h}x{w}: {name} and msda_mm_fwd "
                                "disagree on the same level")
                if not backward:
                    with torch.inference_mode():
                        t_mm = _cuda_ms(lambda: da.msda_mm_fwd(
                            val, x, y, att, h, w), reps=20)
                        t_k1 = _cuda_ms(lambda: da.msda_fwd(
                            k1[0], ((h, w),), k1[1], k1[2]), reps=20)
                        t_lib = _cuda_ms(lambda: _grid_sample_level(
                            val, loc, att, h, w), reps=20)
                        t_plain = _cuda_ms(
                            lambda: da.sample_level_fused_plain(
                                val, x, y, att, h, w), reps=5, warmup=1)
                else:
                    t_mm = _cuda_ms(lambda: da.msda_mm_bwd(
                        val, x, y, att, grad, h, w), reps=20)
                    t_k1 = _cuda_ms(lambda: da.msda_bwd(
                        k1[0], ((h, w),), k1[1], k1[2], k1[3]), reps=20)
                    leaves = [t.detach().requires_grad_(True)
                              for t in (val, loc, att)]
                    lib = _grid_sample_level(*leaves, h, w)
                    t_lib = _cuda_ms(lambda: torch.autograd.grad(
                        lib, leaves, grad, retain_graph=True), reps=20)
                    leaves = [t.detach().requires_grad_(True)
                              for t in (val, x, y, att)]
                    plain = da.sample_level_fused_plain(*leaves, h, w)
                    t_plain = _cuda_ms(lambda: torch.autograd.grad(
                        plain, leaves, grad, retain_graph=True), reps=5,
                        warmup=1)
                    del lib, plain, leaves
                bound, dense = _mm_bounds(B * H, h, w, D, S, x, y)[backward]
                cells[B] = (t_mm, t_k1, t_lib, t_plain, bound, dense)
            f, b = cells[B1], cells[B_TRAIN]
            f32, bf16 = torch.float32, torch.bfloat16
            mm_form = "mm" if h + w <= da._MATMUL_MAX_HW else "gather"
            print(f"[levels] {view} {h}x{w} (under \"mm\": {mm_form}): "
                  f"mm {f[0]:.4f} / {b[0]:.4f}, k1 {f[1]:.4f} / {b[1]:.4f}, "
                  f"lib {f[2]:.4f} / {b[2]:.4f}, plain {f[3]:.4f} / "
                  f"{b[3]:.4f}, bound {f[4][0]:.5f} ({f[4][1]}) / "
                  f"{b[4][0]:.5f} ({b[4][1]}), tiled products at peak "
                  f"{f[5]:.5f} / {b[5]:.5f}; max_abs_err f32 out "
                  f"{cells[B1, f32][0]:.2e} grads "
                  f"{max(cells[B_TRAIN, f32][1:]):.2e}, bf16 out "
                  f"{cells[B1, bf16][0]:.2e} grads "
                  f"{max(cells[B_TRAIN, bf16][1:]):.2e}")
            if (view, h, w) == ("camera_mono", 128, 228):
                reports = {"fwd": f, "bwd": b}
            torch.cuda.empty_cache()
    if not reports:
        raise AssertionError("no camera 128x228 level among the flagship "
                             f"shapes {view_shapes}")

    def report(name, line, key):
        t_mm, _, t_lib, t_plain, bound, _ = reports[key]
        return {"name": name, "route": "cuda",
                "source": "dpft_tpu_torch/csrc/msda_mm.cu",
                "replaces": f"dpft_tpu/ops/pallas/deform_attn_mm.py:{line}",
                "max_abs_err": max_err[key], "ms": t_mm, "plain_ms": t_plain,
                "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": t_lib}

    return report("msda_mm_fwd", 73, "fwd"), report("msda_mm_bwd", 101, "bwd")


def _event_and_host_ms(fn, reps=20, warmup=3):
    """(ms by CUDA events, ms of host time to enqueue) per call of ``fn``:
    where the two agree the host sets the pace."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, 1e3 * host / reps


def _hold_mm_core(view, shapes, value, loc, att, grad):
    """``ms_deform_attn_core(backend="mm")`` as the model calls it, and its
    gradients by autograd, against ``ms_deform_attn_core_mm_plain`` in
    float32. This is the path on which the kernels read each level in place
    from ``value (B, Len, H, D)`` through strides and write into views of
    the level outputs, ``d_value`` and ``d_xy``. Two runs must give the same
    bits of ``d_value`` on every level in matmul form."""
    from dpft_tpu_torch.ops import deform_attn as da

    def run(core):
        leaves = [t.detach().requires_grad_(True) for t in (value, loc, att)]
        out = core(leaves[0], shapes, *leaves[1:])
        return out.detach(), torch.autograd.grad(out, leaves, grad)

    def mm_core(*args):
        return da.ms_deform_attn_core(*args, backend="mm")

    (out, grads), (_, again) = run(mm_core), run(mm_core)
    want, want_grads = run(da.ms_deform_attn_core_mm_plain)
    torch.cuda.synchronize()
    what = f"mm core {view} B={value.shape[0]}"
    errs = [_hold(f"{what} out", out, want, TOL[torch.float32])]
    errs += [_hold(f"{what} {name}", g, wg, BWD_TOL[torch.float32])
             for name, g, wg in zip(("d_value", "d_loc", "d_att"), grads,
                                    want_grads)]
    for _, start, h, w in da._level_starts(shapes):
        rows = slice(start, start + h * w)
        if h + w <= da._MATMUL_MAX_HW and not torch.equal(
                grads[0][:, rows], again[0][:, rows]):
            raise AssertionError(f"{what}: d_value of level {h}x{w} differs "
                                 "between two runs on the same inputs")
    print(f"[core] {view} B={value.shape[0]} f32, mm core in place on "
          f"strided views vs its plain version: max_abs_err out={errs[0]:.3e} "
          f"d_value={errs[1]:.3e} d_loc={errs[2]:.3e} d_att={errs[3]:.3e} "
          f"(tol {TOL[torch.float32]} / {BWD_TOL[torch.float32]} of the "
          "largest element), d_value of the matmul levels bit-equal twice, ok")


def _hold_group_vs_levels(view, shapes, value, loc, att, grad):
    """The grouped launch of all matmul levels of one MSDA call against the
    per-level launches on the same tensors, in place on ``value``: the same
    bits in every level's output and in d_value, d_x, d_y and d_att, and one
    launch per direction."""
    from dpft_tpu_torch.ops import deform_attn as da

    B, _, H, D = value.shape
    N, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    shapes = tuple(map(tuple, shapes))
    sizes = da._level_sizes(shapes, value.device)
    want_xy, want_att_t = da.mm_coords_plain(loc, att, sizes)
    xy, att_t = torch.empty_like(want_xy), torch.empty_like(want_att_t)
    g = grad.view(B, N, H, 1, D).permute(0, 2, 1, 3, 4).expand(
        B, H, N, P, D).reshape(B * H, N * P, D)
    mm, _ = da._split_levels(shapes)
    out = torch.empty((len(mm), B * H, N * P, D), dtype=value.dtype,
                      device="cuda")
    grads = (torch.zeros_like(value), torch.zeros_like(xy),
             torch.zeros_like(att_t))
    before = (da.msda_mm_fwd.launches, da.msda_mm_bwd.launches)
    bins = da.msda_mm_fwd_group(value, mm, loc, att, sizes, xy, att_t, out)
    if not (torch.equal(xy, want_xy) and torch.equal(att_t, want_att_t)):
        raise AssertionError(f"{view}: the launch's own coordinates and "
                             "weights differ from mm_coords_plain")
    da.msda_mm_bwd_group(value, mm, xy, att_t, g, bins, out=grads)
    if (da.msda_mm_fwd.launches, da.msda_mm_bwd.launches) != (
            before[0] + 1, before[1] + 1):
        raise AssertionError(f"{view}: the grouped call took more than one "
                             "launch per direction")
    for k, (lvl, start, h, w) in enumerate(mm):
        level = da._level_view(value, start, h, w)
        args = (level, xy[lvl, 0], xy[lvl, 1], att_t[lvl])
        one = da.msda_mm_fwd(*args, h, w)
        d_val, d_x, d_y, d_att = da.msda_mm_bwd(*args, g, h, w)
        for name, a, b in (
                ("out", out[k], one),
                ("d_val", da._level_view(grads[0], start, h, w), d_val),
                ("d_x", grads[1][lvl, 0], d_x), ("d_y", grads[1][lvl, 1], d_y),
                ("d_att", grads[2][lvl], d_att)):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"{view} B={B} {value.dtype} level {h}x{w}: {name} of "
                    "the grouped launch differs from the per-level launch")
    print(f"[core] {view} B={B} {str(value.dtype)[6:]}: one grouped launch "
          f"of {len(mm)} levels gives the bits of {len(mm)} per-level "
          "launches (out, d_val, d_x, d_y, d_att), and makes the "
          "coordinates and weights of mm_coords_plain bit for bit, ok")


def phase_core_calls(view_shapes):
    """One MSDA call of each view through ``ms_deform_attn_core``: in
    float32 the "mm" backend and its gradients are held against the plain
    hybrid core; then both backends, forward (inference) and forward +
    backward, by CUDA events and by the host's clock: what the "mm" path
    costs per call, shuffles and Python included."""
    from dpft_tpu_torch.ops import deform_attn as da

    for view, shapes in view_shapes.items():
        for B, dtype in ((B1, torch.float32), (B_TRAIN, torch.float32),
                         (B_TRAIN, torch.bfloat16)):
            value, loc, att = _msda_inputs(shapes, B, N_QUERIES, HEADS,
                                           HEAD_DIM, POINTS, dtype, -0.2, 1.2,
                                           seed=5)
            grad = torch.randn(B, N_QUERIES, HEADS * HEAD_DIM, device="cuda",
                               dtype=dtype)
            if dtype == torch.float32:
                _hold_mm_core(view, shapes, value, loc, att, grad)
            _hold_group_vs_levels(view, shapes, value, loc, att, grad)
            cells = []
            for backend in da.BACKENDS:
                with torch.inference_mode():
                    fwd = _event_and_host_ms(lambda: da.ms_deform_attn_core(
                        value, shapes, loc, att, backend=backend))
                leaves = [t.detach().requires_grad_(True)
                          for t in (value, loc, att)]

                def both():
                    out = da.ms_deform_attn_core(leaves[0], shapes,
                                                 *leaves[1:], backend=backend)
                    torch.autograd.grad(out, leaves, grad)

                step = _event_and_host_ms(both)
                cells.append(f"{backend} forward {fwd[0]:.4f} (host "
                             f"{fwd[1]:.4f}), forward + backward "
                             f"{step[0]:.4f} (host {step[1]:.4f})")
            print(f"[core] {view} B={B} {str(dtype)[6:]}, ms per MSDA call: "
                  + "; ".join(cells))


def phase_mm_model(config, model):
    """config/kradar.json with ``fuser.pallas_msda: "mm"`` and the default
    model's weights, against the default model: the B=1 float32 forward
    and one B=4 train step. Returns the mm config and model."""
    import dpft_tpu_torch.models.layers.ms_deform_attn as msda_layer
    from dpft_tpu_torch.models import registry
    from dpft_tpu_torch.models.layers.ms_deform_attn import MSDeformAttn
    from dpft_tpu_torch.ops import deform_attn as da
    from dpft_tpu_torch.training import CentralizedTrainer
    from dpft_tpu_torch.utils.example import example_batch

    mm_config = json.loads(json.dumps(config))
    mm_config["model"]["fuser"]["pallas_msda"] = "mm"
    mm_model = registry.build(mm_config["model"]["name"], mm_config,
                              device="cuda", seed=1)
    mm_model.load_state_dict(model.state_dict(), strict=True)
    backends = {m.backend for m in mm_model.modules()
                if isinstance(m, MSDeformAttn)}
    if backends != {"mm"}:
        raise AssertionError(f"the mm model's MSDA backends: {backends}")

    model.eval()
    mm_model.eval()
    batch = _to_cuda(example_batch(config, B=1, cam_hw=(512, 910)))
    with torch.inference_mode():
        out, ref = mm_model(batch), model(batch)
    for key in ("class", "center", "size", "angle"):
        err = (out[key] - ref[key]).abs().max().item()
        if not torch.allclose(out[key], ref[key], atol=1e-4, rtol=1e-4):
            raise AssertionError(f"{key}: mm model vs default model max abs "
                                 f"err {err:.3e} exceeds 1e-4")
        print(f"[mm] B=1 f32 {key}: mm model vs default model "
              f"max_abs_err={err:.3e} (tol 1e-4) ok")

    trainer = CentralizedTrainer.from_config(config)
    batch, targets = _cuda_batch(config, seed=20)
    step = _step_loss_and_grads(trainer, mm_model, batch, targets)
    # The same model with the plain hybrid core: what the kernels must equal.
    msda_layer.ms_deform_attn_core = _plain_core
    try:
        plain_step = _step_loss_and_grads(trainer, mm_model, batch, targets)
    finally:
        msda_layer.ms_deform_attn_core = da.ms_deform_attn_core
    _compare_steps("mm model", "plain mm-core model", step, plain_step)
    ref_step = _step_loss_and_grads(trainer, model, batch, targets)
    _compare_steps("mm model", "default model", step, ref_step)
    return mm_config, mm_model


def phase_trained_steps(config, model, mm_model):
    """Where the two forms' gradients part, shown on weights that the train
    phases have updated (on the initial weights every query shares one set
    of offsets and hardly a point lies on an integer pixel coordinate). The
    default model's weights go into the mm model, then the same B=4 float32
    step is taken twice by each model, once by each on its plain core, and
    once by each with the points on exactly integer pixel coordinates taken
    out of the coordinate gradient. There the matmul form's derivative is 0
    (the TPU kernel's own) and the gather form's is one-sided, so the forms
    differ by design, kernels and plain versions alike; with those points
    taken out they agree as closely as a model agrees with itself. Reported
    beside each other; held are the loss (1e-4, relative) and finite
    gradients: phases 7 and 11 hold the gradients, on the initial weights."""
    import dpft_tpu_torch.models.layers.ms_deform_attn as msda_layer
    from dpft_tpu_torch.ops import deform_attn as da
    from dpft_tpu_torch.training import CentralizedTrainer

    mm_model.load_state_dict(model.state_dict(), strict=True)
    trainer = CentralizedTrainer.from_config(config)
    batch, targets = _cuda_batch(config, seed=20)
    on_integer = []

    def without_integer_points(value, shapes, loc, att, backend="gather"):
        sizes = da._level_sizes(tuple(map(tuple, shapes)), value.device)
        xy = loc.detach().float() * sizes[:, None, :] - 0.5
        on = xy == xy.round()
        on_integer.append((int(on.sum()), on.numel()))
        return da.ms_deform_attn_core(
            value, shapes, torch.where(on, loc.detach(), loc), att,
            backend=backend)

    def steps(core, n=1):
        msda_layer.ms_deform_attn_core = core
        try:
            return [_step_loss_and_grads(trainer, m, batch, targets)
                    for m in (mm_model, model) for _ in range(n)]
        finally:
            msda_layer.ms_deform_attn_core = da.ms_deform_attn_core

    mm, mm_again, ref, ref_again = steps(da.ms_deform_attn_core, n=2)
    mm_plain, ref_plain = steps(_plain_core)
    mm_out, ref_out = steps(without_integer_points)
    calls = len(on_integer) // 2
    hits, coordinates = map(sum, zip(*on_integer[:calls]))
    print(f"[train] updated weights: {hits} of {coordinates} sampling "
          f"coordinates of the step's {calls} MSDA calls lie on an integer")
    for what, against, a, b, tol in (
            ("mm model", "itself again", mm, mm_again, None),
            ("default model", "itself again", ref, ref_again, None),
            ("mm model", "plain mm-core model", mm, mm_plain, None),
            ("default model", "plain-core model", ref, ref_plain, None),
            ("mm model", "default model", mm, ref, None),
            ("plain mm-core model", "plain-core model", mm_plain, ref_plain,
             None),
            ("mm model without integer points",
             "default model without them", mm_out, ref_out, None)):
        _compare_steps(f"updated weights, {what}", against, a, b, tol=tol)


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
    """Beyond the kernels' limits a CUDA cube raises and launches nothing,
    and the launchers themselves refuse such shapes."""
    import ctypes

    from dpft_tpu_torch.ops import kernels

    # RA: 4 * 8 * 64 * 128 bytes of shared memory; both: 65 doppler bins.
    cases = ((rr.radar_reduce_ra, (64, 8, 128, 4)),
             (rr.radar_reduce_ra, (65, 8, 2, 2)),
             (rr.radar_reduce_ea, (65, 8, 2, 2)))
    for wrapper, shape in cases:
        before = wrapper.launches
        try:
            wrapper(torch.ones(shape, device="cuda"))
        except RuntimeError as exc:
            if "limits" not in str(exc) or wrapper.launches != before:
                raise
        else:
            raise AssertionError(f"{wrapper.__name__} accepted {shape}, "
                                 "beyond its limits")
    # The crop keeps every EA slab the wrapper can ask for inside the shared
    # memory, so the launcher's own refusal is shown on rows [0, 1000).
    lib = kernels.library()
    cube = torch.ones((64, 1000, 1, 1), device="cuda")
    out = torch.zeros((128, 1, 6), device="cuda")
    raster = rr._raster(64).ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    stream = torch.cuda.current_stream().cuda_stream
    codes = (lib.dpft_radar_reduce_ea(cube.data_ptr(), raster, out.data_ptr(),
                                      64, 1000, 1, 1, 0, 1000, stream),
             lib.dpft_radar_reduce_ra(cube.data_ptr(), raster, out.data_ptr(),
                                      64, 1, 128, 1, stream))
    torch.cuda.synchronize()
    if 0 in codes or bool(out.any()):
        raise AssertionError(f"the launchers returned {codes} beyond their "
                             "shared-memory limits")
    print("[radar] beyond their limits both wrappers raise and launch "
          f"nothing, and the launchers refuse (CUDA error codes {codes}), ok")


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
        contiguous = torch.from_numpy(host).cuda()
        # The kernels' own layout, as loadmat gives it: doppler fastest.
        cube = rr.to_doppler_fastest(contiguous)
        if cube.stride() != rr.doppler_fastest_strides(shape) or \
                cube.data_ptr() == contiguous.data_ptr():
            raise AssertionError(f"{shape}: strides {cube.stride()}")
        want_ra, want_ea = rr.reduce_tesseract_plain(contiguous)
        layouts = (("doppler-fastest", cube), ("C-contiguous", contiguous))
        for layout, given in layouts:
            ra = rr.radar_reduce_ra(given)
            ea = rr.radar_reduce_ea(given)
            torch.cuda.synchronize()
            errs = {"ra": _check_plane(f"radar_reduce_ra {shape} {layout}",
                                       ra, want_ra),
                    "ea": _check_plane(f"radar_reduce_ea {shape} {layout}",
                                       ea, want_ea)}
            for key in max_err:
                max_err[key] = max(max_err[key], errs[key][0])
            print(f"[radar] {shape} {layout} kernel vs plain: ra max_abs_err="
                  f"{errs['ra'][0]:.3e}, ea max_abs_err={errs['ea'][0]:.3e} "
                  f"(rtol {RADAR_TOL['rtol']}, atol {RADAR_TOL['atol']}), "
                  "lookup channel exact, ok")
        for key in ("ra", "ea"):
            print(f"[radar]   {key} channels 0-5: typical |value| "
                  f"{_channels(errs[key][2])}, max abs err "
                  f"{_channels(errs[key][3])}")
        # A float64 cube, as the prepare path sends it: cast on the card,
        # the same bits as from the float32 cube.
        before = (rr.radar_reduce_ra.launches, rr.radar_reduce_ea.launches)
        planes = rr.reduce_tesseract(cube.double())
        if not (torch.equal(planes[0], ra) and torch.equal(planes[1], ea)) \
                or (rr.radar_reduce_ra.launches,
                    rr.radar_reduce_ea.launches) != (before[0] + 1,
                                                     before[1] + 1):
            raise AssertionError(f"{shape}: reduce_tesseract of the float64 "
                                 "cube differs from the float32 cube's planes")
        # The kernel's reading of its layout: any other stride pattern raises.
        try:
            rr.radar_reduce_ea(contiguous.permute(1, 0, 2, 3).contiguous()
                               .permute(1, 0, 2, 3))
        except ValueError:
            pass
        else:
            raise AssertionError("radar_reduce_ea accepted a range-fastest "
                                 "cube")
    print("[radar] a float64 doppler-fastest cube through reduce_tesseract "
          "gives the float32 cube's planes bit for bit at every shape; a "
          "cube in another layout raises, ok")
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

    # Times by CUDA events: the kernels on their own layout (no copy before
    # them), on a C-contiguous cube (the wrapper's layout copy included),
    # that copy and the float64 -> float32 cast apart, the plain version.
    times = {}
    for layout, given in layouts:
        times[layout] = (
            _cuda_ms(lambda: rr.radar_reduce_ra(given), reps=20, warmup=2),
            _cuda_ms(lambda: rr.radar_reduce_ea(given), reps=20, warmup=2))
    ra_ms, ea_ms = times["doppler-fastest"]
    copy_ms = _cuda_ms(lambda: rr.to_doppler_fastest(contiguous), reps=10,
                       warmup=2)
    cube64 = cube.double()
    cast_ms = _cuda_ms(lambda: cube64.to(torch.float32), reps=10, warmup=2)
    cast_bound = 1e3 * 12 * cube.numel() / PEAK_BYTES_PER_S
    del cube64
    plain_ms = _cuda_ms(lambda: rr.reduce_tesseract_plain(contiguous), reps=3,
                        warmup=1)
    ra_bound, ea_bound = _radar_bounds(shape)
    print(f"[radar] {shape} one cube, doppler-fastest: radar_reduce_ra "
          f"{ra_ms:.4f} ms (bound {ra_bound[0]:.4f} ms, {ra_bound[1]}: "
          f"{ra_ms / ra_bound[0]:.2f} times), radar_reduce_ea {ea_ms:.4f} ms "
          f"(bound {ea_bound[0]:.4f} ms, {ea_bound[1]}: "
          f"{ea_ms / ea_bound[0]:.2f} times); C-contiguous, the wrapper's "
          f"layout copy included: {times['C-contiguous'][0]:.4f} / "
          f"{times['C-contiguous'][1]:.4f} ms; the layout copy alone "
          f"{copy_ms:.4f} ms; the float64 -> float32 cast on the card "
          f"{cast_ms:.4f} ms (bound {cast_bound:.4f} ms, bytes); plain "
          f"version of both planes {plain_ms:.3f} ms")

    # Host to card: one cube from pageable and from pinned memory, in
    # float32 and in float64 (what the prepare path now sends); the bound
    # is the card's own memory rate, which the bus does not reach.
    for label, array in (("float32", host),
                         ("float64", host.astype(np.float64))):
        pinned = torch.from_numpy(array).pin_memory()
        pageable = torch.from_numpy(array)
        copy_bound = 1e3 * array.nbytes / PEAK_BYTES_PER_S
        page_ms = _cuda_ms(lambda: pageable.to("cuda"), reps=5, warmup=1)
        pin_ms = _cuda_ms(lambda: pinned.to("cuda", non_blocking=True),
                          reps=5, warmup=1)
        print(f"[radar] copy of one {label} cube ({array.nbytes / 1e6:.1f} "
              f"MB) to the card: pageable {page_ms:.3f} ms "
              f"({array.nbytes / page_ms / 1e6:.2f} GB/s), pinned "
              f"{pin_ms:.3f} ms ({array.nbytes / pin_ms / 1e6:.2f} GB/s); "
              f"{copy_bound:.4f} ms at the card's memory rate")
        del pinned, pageable

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


def phase_radar_kernel_times():
    """Device time of the radar kernels, the layout copy and the cast on
    one K-Radar cube, by name (torch.profiler, mean of 10 calls). Runs after
    every timed phase, as ``phase_launch_counts`` does."""
    from torch.profiler import ProfilerActivity, profile

    from dpft_tpu_torch.ops import radar_reduce as rr

    contiguous = torch.from_numpy(_power_cube(KRADAR_CUBE, seed=0)).cuda()
    cube64 = rr.to_doppler_fastest(contiguous).double()

    def both():
        rr.reduce_tesseract(cube64)          # cast, then both kernels
        rr.to_doppler_fastest(contiguous)    # the layout copy

    both()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            both()
        torch.cuda.synchronize()
    cells = []
    for event in prof.key_averages():
        if event.device_time_total > 0 and \
                event.device_type == torch.autograd.DeviceType.CUDA:
            key = event.key
            name = key[key.find("radar_"):].split("<")[0].split("(")[0] \
                if "radar_" in key else key.split("<")[0][:48]
            cells.append(f"{name} "
                         f"{event.device_time_total / event.count:.1f}")
    print(f"[kernel times] {KRADAR_CUBE} float64 cube through "
          "reduce_tesseract (cast + both kernels) and the layout copy of a "
          f"C-contiguous cube, us per launch: "
          f"{', '.join(sorted(cells)) or 'not measured'}")


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
        # The entry point itself turns TF32 off.
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        _reset_launches()
        _, run_s = _host_s(lambda: prepare.main(src, config_path, dst))
        launches = _read_launches()
        _assert_full_float32("prepare.main")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        expected = dict.fromkeys(KERNELS, 0)
        expected.update(radar_reduce_ra=n_frames, radar_reduce_ea=n_frames)
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
        cube64, copy_s = _host_s(lambda: torch.from_numpy(raw).cuda())
        cube, cast_s = _host_s(lambda: cube64.to(torch.float32))
        planes, kernel_s = _host_s(lambda: rr.reduce_tesseract(cube))
        planes, back_s = _host_s(lambda: [p.cpu().numpy() for p in planes])
        _, save_s = _host_s(lambda: [
            np.save(os.path.join(again, f"{n}.npy"), p, allow_pickle=False)
            for n, p in zip(("ra", "ea"), planes)])
        radar_s = load_s + copy_s + cast_s + kernel_s + back_s + save_s
        print(f"[prepare] one frame on one worker: {frame_s:.3f} s = loadmat "
              f"{load_s:.3f} + copy of the float64 cube to the card "
              f"{copy_s:.4f} + cast on the card {cast_s:.4f} + both kernels "
              f"{kernel_s:.4f} + planes back {back_s:.4f} + ra/ea.npy "
              f"{save_s:.4f} s (radar {radar_s:.3f} s) + camera, lidar, "
              f"labels and their files {frame_s - radar_s:.3f} s; cast and "
              f"kernels are {100 * (cast_s + kernel_s) / frame_s:.2f}% of "
              "the frame")
        del cube64, cube
        # The same frame the way it went before: cast on the host, then the
        # float32 cube over the bus.
        host, host_cast_s = _host_s(lambda: raw.astype(np.float32))
        _, host_copy_s = _host_s(lambda: torch.from_numpy(host).cuda())
        print(f"[prepare]   with the cast on the host instead: astype "
              f"{host_cast_s:.3f} + copy of the float32 cube "
              f"{host_copy_s:.4f} s = {host_cast_s + host_copy_s:.3f} s "
              f"against {copy_s + cast_s:.3f} s")
        del host, raw

        # What the processor hands to the reduction, and what one worker
        # holds on the card meanwhile.
        import dpft_tpu_torch.data.kradar.processor as processor_module
        seen = []

        def spy(cube):
            seen.append((cube.dtype, cube.device.type, tuple(cube.stride())))
            return rr.reduce_tesseract(cube)

        torch.cuda.synchronize()
        held_now = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        processor_module.reduce_tesseract = spy
        try:
            processor.get_radar_data(sample["radar_tesseract"])
        finally:
            processor_module.reduce_tesseract = rr.reduce_tesseract
        worker = (torch.cuda.max_memory_allocated() - held_now) / 2 ** 30
        want = (torch.float64, "cuda", rr.doppler_fastest_strides(KRADAR_CUBE))
        if seen != [want]:
            raise AssertionError(f"the processor handed {seen} to the "
                                 f"reduction, expected {want}")
        cube_gib = 4 * math.prod(KRADAR_CUBE) / 2 ** 30
        if worker > 3 * cube_gib + 0.01:
            raise AssertionError(f"one worker held {worker:.3f} GiB, more "
                                 "than a float64 and a float32 cube")
        print(f"[prepare] the processor sends the cube as loadmat gives it "
              f"(float64, doppler-fastest, no astype on the host); one "
              f"worker holds at most {worker:.3f} GiB on the card (a float64"
              f" cube {2 * cube_gib:.3f} + a float32 cube {cube_gib:.3f} "
              "GiB)")

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


def _assert_full_float32(after):
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError(f"TF32 is on after {after}")


def _flagship_model(config):
    """config/kradar.json built on the card from seed 0, and the level
    shapes of its three views."""
    from dpft_tpu_torch.models import registry
    from dpft_tpu_torch.utils.example import example_batch

    t0 = time.perf_counter()
    model = registry.build(config["model"]["name"], config, device="cuda",
                           seed=0)
    print(f"[flagship] built config/kradar.json on cuda in "
          f"{time.perf_counter() - t0:.1f} s")
    with torch.inference_mode():
        views = model.features(_to_cuda(example_batch(config, B=1,
                                                      cam_hw=(512, 910))))
    return model, dict(zip(model.inputs, (shapes for _, shapes in views)))


def main():
    phase_device()
    # The phases below drive the evaluator and the trainer, not the CLIs'
    # ``main``, which call this themselves.
    from dpft_tpu_torch.utils.device import use_full_float32
    use_full_float32()
    phase_build()

    config_path = os.path.join(ROOT, "config", "kradar.json")
    with open(config_path) as f:
        config = json.load(f)
    model, view_shapes = _flagship_model(config)

    fwd_report = phase_kernel_vs_plain(view_shapes)
    phase_flagship(config, model)
    paths = {"serve": phase_serve(config, model, view_shapes)}
    _assert_full_float32("the serve phase")
    bwd_report = phase_bwd_vs_plain(view_shapes)
    phase_train_step_vs_plain(config, model)
    phase_step_backward_twice(config, model)
    # On the initial weights, as the step above: the train phases leave
    # weights on which one step's gradients are ill-conditioned.
    mm_config, mm_model = phase_mm_model(config, model)
    paths["train"] = phase_train(config, model, view_shapes)
    _assert_full_float32("the train phase")
    phase_train_timing(config, model)

    mm_fwd_report, mm_bwd_report = phase_mm_vs_plain(view_shapes)
    phase_core_calls(view_shapes)
    paths["serve_mm"] = phase_serve(mm_config, mm_model, view_shapes,
                                    label="serve_mm")
    paths["train_mm"] = phase_train(mm_config, mm_model, view_shapes,
                                    label="train_mm", epochs=1, n_train=2,
                                    n_val=1, resume=False)
    _time_forwards(mm_config, mm_model, "flagship_mm")
    phase_train_timing(mm_config, mm_model, label="train_mm")
    phase_trained_steps(config, model, mm_model)
    ra_report, ea_report = phase_radar_vs_plain()
    phase_launch_counts(config, {"default": model, "mm": mm_model})
    phase_kernel_times(view_shapes)
    phase_msda_call_times(view_shapes)
    phase_radar_kernel_times()
    del mm_model
    torch.cuda.empty_cache()
    paths["prepare"] = phase_prepare(config_path, config, model)
    # `launches` is the count on the kernel's own main path.
    reports = [(fwd_report, "train"), (bwd_report, "train"),
               (mm_fwd_report, "train_mm"), (mm_bwd_report, "train_mm"),
               (ra_report, "prepare"), (ea_report, "prepare")]
    for report, own_path in reports:
        name = report["name"]
        report["launches"] = paths[own_path][name]
        report["launches_by_path"] = {path: launches[name]
                                      for path, launches in paths.items()}
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    print(smi.splitlines()[0] if smi else smi)
    print(json.dumps({"kernels": [report for report, _ in reports]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
