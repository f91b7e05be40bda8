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
   The same forward's FLOPs (the evaluator's count) give the achieved
   TFLOP/s of each case. A forward with a swapped MSDA core runs under
   ``_Eager``, so that no stage replays a graph captured with the kernels.
4b. CUDA graphs (``phase_graphs``): the eval forward's stages
   (models/graphs.py) on a copy of the flagship and on
   config/kradar_radar.json at B=1 and B=4 in f32: replays bit-equal to
   the eager forward under ``inference_mode`` and ``no_grad``, held
   outputs unchanged by the next call, exact ``msda_fwd`` launches per
   replayed forward, in-place weight updates read, graphs dropped after
   ``.to()`` and ``load_state_dict(assign=True)``, FLOPs unchanged; the
   two models' replays in turns from the one memory pool.
5. Serve path (the first main path): registry.save -> registry.load ->
   CentralizedEvaluator over two synthetic batches -> the K-Radar txt tree.
   The launch counts of both kernels are reset right before it and read
   right after: msda_fwd exactly once per MSDA call, msda_bwd never (the
   FLOP count's forward included). Its FLOPS (in the results and in
   results.json) must equal a reckoning by forward hooks (2 x the
   multiply-adds of every convolution, linear layer and attention product,
   the MSDA formula per call), and under "mm" (phase 12) the default's.
5b. Export path (the sixth main path): the flagship model at B=1 in f32
   and in bf16 through ``export.export_forward`` (no kernel launched while
   tracing; the program holds one ``dpft.msda_fwd`` node per view and
   iteration and, in bf16, an autocast region) and ``save_exported``; a
   fresh interpreter that imports torch and ``dpft_tpu_torch.ops.
   deform_attn`` only (``dpft_tpu_torch.models`` must stay unimported)
   loads both and runs them on the card on the batches of seed 0 and 1:
   within 1e-5 (f32) and 2e-2 (bf16) of each output's largest element of
   the eager forward, exactly 12 msda_fwd launches per forward and no
   other. Export, save and load seconds, ms per forward of the loaded
   program and of the eager model by CUDA events. The same in f32 under
   ``fuser.pallas_msda: "mm"`` (``export_mm``, after phase 12; on the mm
   config cut in depth, ``cut_depth_config``: ResNet-18
   backbones and one fusion iteration, from seed 0): one
   ``dpft.msda_mm_fwd`` node per view and iteration and no
   ``dpft.msda_fwd`` node; per forward of the loaded program exactly one
   ``msda_mm_fwd`` launch per view and iteration, one ``msda_fwd`` per
   level above the cutoff and iteration (the camera's 512x910) and no
   backward.
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
   backward passes through the operator ``dpft::msda_fwd`` (whose
   backward is ``dpft::msda_bwd``) must give the same bits of
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
9b. Data parallel (the train_dp path, ``phase_data_parallel``): the
   flagship B=4 f32 step with dropout 0 (each rank draws its own masks) on
   the model from seed 0 without a process group is the reference. In a
   one-rank NCCL group joined through ``parallel.init_distributed``'s
   torchrun route, the step through ``parallel.distribute`` (global
   BatchNorm, FSDP2 on the (1, 1) mesh) equals it (loss 1e-4 relative,
   gradients and BatchNorm running statistics 1e-3 of their largest) with
   12 ``msda_fwd`` and 12 ``msda_bwd`` launches. Then two spawned
   processes share the card in a gloo group (NCCL refuses two ranks on
   one card), two rows each (the eval_dp and train_dp paths): the
   evaluator on the ranks gives one process's FLOPs and parameters
   exactly and its metrics within 1e-4; in float64 on the plain core the
   loss, the all-reduced gradients and the running statistics equal the
   float64 reference within 1e-6 of their largest; in float32 with the
   kernels the loss (1e-4) and the running statistics (1e-3) are held and
   the gradients printed beside the float32-vs-float64 spread of one
   process, which is as large; each rank holds msda_fwd and msda_bwd on
   every MSDA call of its step (B=2, its own inputs and output gradients)
   against the plain version at phase 1's and 6's bounds, and launches 12
   + 12 in the step. Float64 probes without a group print where the
   float32 spread comes from (perturbed inputs, locations moved by an
   ulp). Printed: ms per step (CUDA events, 5 after 2) without a group,
   under torch's DDP alone at world size 1 (for comparison; the port does
   not use it), through ``distribute`` at world size 1, and on each gloo
   rank, with the peak memory of each.
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
   level above it, per iteration and forward, the FLOP count's forward
   included (the matmul form is the operator ``dpft::msda_mm_fwd``, counted
   in its own form), and the same FLOPS as the default's.
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
   temporary directory (with two large Sedans per frame,
   ``rewrite_labels``), then
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
   the same frame with the cast on the host. Last, before the tree is
   removed, ``dpft_tpu_torch.export.main`` (the export CLI, ``--batch 1``)
   on it (for the flagship cut in depth, ``cut_depth_config``, from seed
   0): no kernel launched while tracing, and its artifact runs
   the test frame within 1e-5 of each output's largest element of the
   eager model. Then, still on that tree (``reference_ckpt``): that model
   as a reference full-model pickle (``write_reference_pickle``: ``dprt.*``
   stub classes, no class of the port, and a ``torch.device``, a
   ``functools.partial``, a numpy array and ``torch.nn.functional.relu``
   beside the tensors) through ``registry.load`` on the card (the same
   state bits), ``dpft_tpu_torch.evaluate.main`` (a finite mAP) and
   ``dpft_tpu_torch.export.main`` (the artifact runs the test frame within
   1e-5); and two pickles that would create a marker file when unpickled
   (``os.system``, ``builtins.exec``) raise and create nothing.
16. Backbone families (after phase 14's timings, before phase 15):
   config/kradar.json with every view's backbone ConvNeXt-T (and the
   learnable querent), Swin-T or RegNet-Y-400MF (``family_config``), at
   production shapes from seed 0: a B=1 f32 forward within 1e-5 of each
   output's largest element of the same model on the plain core, exactly
   12 ``msda_fwd`` launches; one B=4 f32 train step against the plain
   core's (loss 1e-4 relative, gradients 1e-3 of their largest), exactly
   12 ``msda_fwd`` and 12 ``msda_bwd`` launches; a finite B=1 bf16
   forward; the FLOP count equal to the reckoning by hooks; forward ms at
   B=1 and B=4 and train step ms by CUDA events, peak memory, build
   seconds. In the Swin-T model the forward takes every block's attention
   through ``window_attn_fwd`` (one launch a block and view), its
   reference the plain attention (``_plain_core_eager``), and the bf16
   forward launches exactly what the f32 one does. Every phase from
   export_mm on prints its seconds, and the script its total.
17. Configs (after phase 16): the four other shipped configs (the camera
   alone, both radar views, the BEV plane alone, the front plane alone) at
   full width from seed 0, each held as phase 16 holds a family: exactly
   ``m_views x i_iter`` ``msda_fwd`` launches per forward and ``msda_bwd``
   per step. In phase 15, on the tree it wrote: ``prepare_device:
   "native"`` on the raw tree (the same files, the planes against the
   card's) and ``dpft_tpu_torch.train.main`` for one epoch and
   ``evaluate.main`` with config/kradar_radar_bev.json: at least one step
   with a loss above 0, at least one labelled object in the test split,
   and an mAP of 1.0 only where every test sample has fewer than two
   classes among its targets and predicted labels (the metric's rule).
18. Remat (after phase 9b): the flagship B=4 f32 step with
   ``computing.remat`` against without (gradients 1e-3 of their largest,
   beside the spread of two steps without; every buffer bit-equal; the
   same launches); ms per step and peak memory with and without at B=4
   and B=16. Phase 7 also runs its two backward passes with
   ``cudnn.deterministic`` on, and times the step both ways.
19. Tensor parallel (after phase 9b): in a one-rank NCCL group joined
   through ``init_distributed`` (``computing.model_parallel`` 1, a (1, 1)
   mesh), the flagship through ``parallel.distribute`` (FSDP2): its B=4
   f32 step against the step without a group (phase 7's bounds), 12 + 12
   launches, ms per step; ``CentralizedTrainer`` in float64 on the plain
   core (the flagship cut to ResNet-18 backbones and one fusion
   iteration, ``cut_depth_config``) with deterministic algorithms, SGD
   with momentum and
   ``accumulate_steps`` 2, one epoch with ``save_optimizer`` and one
   resumed from it, every tensor of its checkpoints and optimizer states
   within ``TP_FIT_TOL`` of the run without a group, the last checkpoint
   loading in one process with the same bits (after the cast to the
   config's float32 model). Then two gloo ranks sharing the card on a (1,
   2) mesh (``parallel.make_mesh``): their float64 step on the plain core
   equals the float64 step without a group within 1e-9, with each rank's
   bytes of parameters and moments and its peak memory.
20. Checkpoint writer: the flagship saved twice by
   ``registry.CheckpointSaver``: ms the epoch waits (the copy to the host)
   and ms of the whole commit, the size, the bits read back.
21. Host radar reduction (before phase 15): ``prepare_device: "native"``'s
   kernel (csrc/radar_reduce_host.cc, g++) on a full K-Radar cube against
   the CUDA kernels' planes (phase 14's tolerance; the lookup channel may
   name another doppler bin only at a tie: where the two bins' maxima of
   10 log10, taken in float64 from the cube, lie within ``TIE_ULPS``
   float32 ulps; each such gap is printed), ms per cube on the host with
   its CPU's name.
22. Bench (last, ``phase_bench``): ``python -m dpft_tpu_torch.bench``
   through its real entry, each run in a fresh process with BENCH_REPS 1
   and BENCH_WARMUP 1, all at once (the entry's timings are not read
   here: the benchmark under h100_bench/ measures): the default run
   (inference, B=4, bfloat16), train at B=4 in float32 with
   BENCH_FLOPS=1, prepare on the default device (the four frame ids of
   tests/kradar_fixture.py at K-Radar's shapes; without the NumPy
   baseline), inference at B=1 in float32 as the cell ``1:f32`` of
   ``python -m dpft_tpu_torch.bench_scaling`` (which passes the bench's
   stderr on), and BENCH_HOIST=1. Each run exits 0 with a last
   line of exactly the port's keys for its mode (``port_bench_keys``: the
   root bench.py's, read from its source with ``ast``, with the port's
   changes) naming this card and its power limit; the inference FLOPs
   equal the serve path's count per B=1 forward times B, the train step's
   lie within 2-4 times the forward's (the ratio printed); prepare reports
   every frame of its tree; TF32 is off at the end of every run and the
   kernels it launched (its ``bench:`` line on stderr) are its mode's;
   BENCH_HOIST=1 exits 1 with an error line. Each run's last line is
   printed whole.

23. Overfit (``phase_overfit``, before phase 15): tests/test_overfit_metrics.
   py's recipe at the small config, from the port's own init at seeds 0-3
   (``OVERFIT_RUNS``; two classes and ``"mm"`` at seed 0). The fixture's
   raw tree (``write_fixture_tree``: tests/kradar_fixture.py's files and
   bits, the recipe's two large boxes) is prepared on the card by
   ``prepare.main`` (the radar kernels at 6 elevation bins, exactly one of
   each per cube, the planes held against the plain version within
   ``FIXTURE_RADAR_TOL``: the overfit_prepare path), then each run trains
   80 epochs through ``CentralizedTrainer.train`` with no checkpoint and
   exact launches (the overfit and overfit_mm paths); its first 10 epochs'
   losses are held against the plain core's from the same init
   (``PLAIN_LOSS_RTOL``). The floors (``floor_failures``: the test's, and
   two classes present in every sample) are held at
   ``CPU_MET_FLOORS_NUDGED`` and printed elsewhere.
   The first held run is saved once (``registry.save``) and goes through
   ``evaluate.main`` (finite mAP and mGIoU in results.json) and
   ``export.main`` (the artifact within 1e-5 of the eager outputs on the
   test frame). In phase 15, on its K-Radar-shape tree, whose labels are
   the same two boxes (``phase_overfit_flagship``): config/kradar.json
   from seed 0 for as many
   epochs as ``FLAGSHIP_OVERFIT_S`` allows, no checkpoint, exact launches
   (overfit_flagship); the loss finite and its last epoch below half its
   first; the small recipe's floor readings printed, not held.

24. Window attention (``phase_window_attn``, before phase 16):
   ``window_attn_fwd`` against ``window_attention_plain`` on the card at
   the four stage shapes of the Swin-B camera at 512x910 (B=1), unshifted
   and shifted by 3: float32 within 1e-5 of the plain output's largest
   element, bfloat16 qkv within 2e-2 of the plain version on the same
   bfloat16 values in float32. Device times (busy time by the profiler,
   ``profiling.device_activity``; the kernel's CUDA-event time beside it,
   which a wrapper call's host work sets in stages 3 and 4) of the kernel,
   the plain version, and PyTorch's fused attention on the partitioned
   windows (``_window_attn_library``), per stage and shift and over one
   frame's 24 blocks, each beside its bound.

The kernel report gives, for every kernel, its launches on every main
path (serve, export, train, eval_dp and train_dp (rank 0's: 9 eval
forwards, one step), train_tp, train_remat, serve_mm,
export_mm, train_mm, serve_<family> and train_<family> of the three
families and of the four configs, prepare, overfit_prepare, overfit,
overfit_mm, overfit_flagship), its error against the plain
version, its time, the plain version's,
and ``bound_ms``: the least time the card could take, the larger of the
bytes the function must move (every input read once, every output written
once; for MSDA only the 32-byte sectors of the value map that this run's
sampling points touch) over 3.35 TB/s and its float32 operations over
67 TFLOP/s. For every MSDA kernel, the matmul-form ones too, these are
the operations of the function, ``ops.deform_attn.msda_operations`` (10
per corner and channel of every sampling point forward, 30 backward), the
formula that the evaluator's FLOP count takes too; the dense products that
the matmul form itself computes are printed apart, in the per-level lines.
``library_ms`` is ``grid_sample`` times att for the matmul-form kernels
(camera 128x228 level); for ``msda_fwd`` / ``msda_bwd`` the reference's own
PyTorch core, ``grid_sample`` per level times the attention, summed
(``grid_sample_core``, the camera call at B=1 / B=4, forward / autograd's
backward); null for the radar kernels: no PyTorch call computes a plane.
For ``window_attn_fwd`` the times (device busy time by the profiler), the
bound and ``library_ms`` (roll, window partition and
``F.scaled_dot_product_attention`` with the bias and mask as one additive
mask made beforehand) are of one Swin-B camera frame's 24 calls at B=1;
its ``replaces`` is null: the JAX package
computes Swin's attention with plain XLA operations.

The last two lines are the kernel report and the result:
    {"kernels": [...]}
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}
"""

import contextlib
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
           "radar_reduce_ra", "radar_reduce_ea", "window_attn_fwd")
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
# The fixture's cube (uniform powers, 6 elevation bins) makes the last
# channel of the EA plane typically 0.011 (0.3 in RA), where the plain
# version lies 1.7e-6 (6.6e-6) from the numpy transliteration in float64
# (on the CPU): held with a hundredth of the atol.
FIXTURE_RADAR_TOL = dict(rtol=3e-4, atol=3e-4)

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
    from dpft_tpu_torch.ops import window_attn as wa

    return {**da.LAUNCH_COUNTED, **rr.LAUNCH_COUNTED, **wa.LAUNCH_COUNTED}


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
    per view and iteration; one ``window_attn_fwd`` launch per Swin block
    of every forward that no backward follows (those run without
    gradient)."""
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
    expected["window_attn_fwd"] = _swin_blocks(config) * (forwards - steps)
    return expected


def _swin_blocks(config):
    """Swin blocks of the model of ``config``, over every view."""
    from dpft_tpu_torch.models.backbones.swin import _VARIANTS

    model = config["model"]
    blocks = 0
    for view in model["inputs"]:
        bcfg = model["backbones"][view]
        variant = _VARIANTS.get(bcfg["name"].lower())
        if variant is not None:
            blocks += sum(variant[1][:bcfg.get("multi_scale", 1)])
    return blocks


def _plain_core(value, shapes, loc, att, backend="gather"):
    """The plain PyTorch version of the layer's MSDA core."""
    from dpft_tpu_torch.ops import deform_attn as da

    plain = (da.ms_deform_attn_core_mm_plain if backend == "mm"
             else da.ms_deform_attn_core_plain)
    return plain(value, shapes, loc, att)


class _Eager(torch.overrides.TorchFunctionMode):
    """A mode that changes no operation. While it is active every stage of
    the model runs eagerly (``models/graphs.py``): the reference for a
    replay, and the way to run a swapped MSDA core, which no graph sees."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _plain_core_eager():
    """The layer's MSDA core swapped for the plain one in this process,
    every Swin block on its plain attention, and every stage held eager
    (``_Eager``): a replay would run the kernels that its capture saw, not
    the swapped core. Every eval forward on a swapped core goes through
    here."""
    import dpft_tpu_torch.models.layers.ms_deform_attn as msda_layer
    from dpft_tpu_torch.models.backbones import swin
    from dpft_tpu_torch.ops import deform_attn as da

    fused = swin.fused
    msda_layer.ms_deform_attn_core = _plain_core
    swin.fused = lambda qkv: False
    try:
        with _Eager():
            yield
    finally:
        msda_layer.ms_deform_attn_core = da.ms_deform_attn_core
        swin.fused = fused


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
                    da.msda_operations(args[2].shape, D))
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


# The Swin-B camera's stages at 512x910: (H, W, C, heads, blocks).
SWIN_B_STAGES = ((128, 227, 128, 4, 2), (64, 114, 256, 8, 2),
                 (32, 57, 512, 16, 18), (16, 29, 1024, 32, 2))


def _window_attn_library(qkv, bias_mask, heads, shift):
    """Window attention through PyTorch's fused attention: the map rolled
    and cut into windows, ``F.scaled_dot_product_attention`` with
    ``bias_mask`` (the bias plus, when shifted, the mask), the reverse."""
    import torch.nn.functional as F

    B, Hp, Wp, C3 = qkv.shape
    C, w = C3 // 3, 7
    if any(shift):
        qkv = torch.roll(qkv, (-shift[0], -shift[1]), dims=(1, 2))
    qkv = qkv.reshape(B, Hp // w, w, Wp // w, w, C3).permute(
        0, 1, 3, 2, 4, 5).reshape(-1, w * w, 3, heads, C // heads).permute(
        2, 0, 3, 1, 4)
    out = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2],
                                         attn_mask=bias_mask)
    out = out.transpose(1, 2).reshape(B, Hp // w, Wp // w, w, w, C).permute(
        0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    if any(shift):
        out = torch.roll(out, shift, dims=(1, 2))
    return out


def phase_window_attn():
    """``window_attn_fwd`` against the plain version at the Swin-B
    camera's stages (see the module docstring); returns the kernel report
    entry, its times and bound those of one frame's 24 calls."""
    from dpft_tpu_torch.ops import window_attn as wa
    from dpft_tpu_torch.utils import profiling

    def device_ms(fn):
        return profiling.device_activity(fn, reps=10, device="cuda").busy_ms

    w = wa.WINDOW
    index = wa.relative_position_index(w).cuda()
    gen = torch.Generator("cuda").manual_seed(0)
    max_err = 0.0
    frame = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms"), 0.0)
    bound_by = set()
    for H, W, C, heads, blocks in SWIN_B_STAGES:
        Hp, Wp = -(-H // w) * w, -(-W // w) * w
        qkv = torch.randn(1, Hp, Wp, 3 * C, device="cuda", generator=gen)
        table = torch.randn((2 * w - 1) ** 2, heads, device="cuda",
                            generator=gen)
        low = qkv.bfloat16()
        for s in (0, w // 2):   # every stage's padded sides exceed a window
            shift = (s, s)
            mask = wa.shift_mask(Hp, Wp, w, shift, "cuda") if s else None
            bias = table[index].reshape(w * w, w * w, heads).permute(2, 0, 1)
            bias_mask = (bias[None] + mask[:, None] if s
                         else bias[None]).contiguous()
            with torch.inference_mode():
                got = wa.window_attn_fwd(qkv, table, index, heads, *shift)
                want = wa.window_attention_plain(qkv, table, index, heads,
                                                 shift, mask)
                got_low = wa.window_attn_fwd(low, table, index, heads,
                                             *shift)
                want_low = wa.window_attention_plain(
                    low.float(), table, index, heads, shift, mask)
                lib = _window_attn_library(qkv, bias_mask, heads, shift)
                torch.cuda.synchronize()
            scale = want.abs().max().item()
            err = (got - want).abs().max().item()
            err_low = ((got_low.float() - want_low).abs().max().item()
                       / want_low.abs().max().item())
            err_lib = (lib - want).abs().max().item() / scale
            if got_low.dtype != torch.bfloat16 or \
                    not err <= TOL[torch.float32] * scale or \
                    not err_low <= TOL[torch.bfloat16]:
                raise AssertionError(
                    f"window_attn_fwd {H}x{W}x{C} shift {s}: f32 err "
                    f"{err:.3e} of {scale:.3e}, bf16 {err_low:.3e} of the "
                    f"largest ({got_low.dtype})")
            max_err = max(max_err, err)
            with torch.inference_mode():
                e_ms = _cuda_ms(lambda: wa.window_attn_fwd(
                    qkv, table, index, heads, *shift))
                k_ms = device_ms(lambda: wa.window_attn_fwd(
                    qkv, table, index, heads, *shift))
                p_ms = device_ms(lambda: wa.window_attention_plain(
                    qkv, table, index, heads, shift, mask))
                l_ms = device_ms(lambda: _window_attn_library(
                    qkv, bias_mask, heads, shift))
            # qkv, the table and the index read once, the output written
            # once; both products over the padded windows.
            bound = _bound(_nbytes(qkv, table, index, got),
                           wa.window_attn_operations(qkv.shape))
            bound_by.add(bound[1])
            for key, ms in (("ms", k_ms), ("plain_ms", p_ms),
                            ("library_ms", l_ms), ("bound_ms", bound[0])):
                frame[key] += blocks / 2 * ms   # half the blocks shifted
            print(f"[window_attn] {H}x{W} (padded {Hp}x{Wp}) C={C} "
                  f"heads={heads} shift={s}: f32 max_abs_err={err:.3e} of "
                  f"{scale:.3e} (tol {TOL[torch.float32]} of it), bf16 "
                  f"{err_low:.3e} of the largest (tol "
                  f"{TOL[torch.bfloat16]}); on the card: kernel "
                  f"{1e3 * k_ms:.2f} us ({1e3 * e_ms:.2f} by events), "
                  f"plain {1e3 * p_ms:.2f} us, library {1e3 * l_ms:.2f} us "
                  f"(gap {err_lib:.2e} of the largest), bound "
                  f"{1e3 * bound[0]:.2f} us ({bound[1]}); "
                  f"{100 * bound[0] / k_ms:.1f}% of the bound")
    print(f"[window_attn] one Swin-B frame (24 calls, B=1), on the card: "
          f"kernel "
          f"{1e3 * frame['ms']:.1f} us, plain {1e3 * frame['plain_ms']:.1f} "
          f"us, library {1e3 * frame['library_ms']:.1f} us, bound "
          f"{1e3 * frame['bound_ms']:.1f} us: the kernel at "
          f"{100 * frame['bound_ms'] / frame['ms']:.1f}% of the bound")
    return {"name": "window_attn_fwd", "route": "cuda",
            "source": "dpft_tpu_torch/csrc/window_attn.cu", "replaces": None,
            "max_abs_err": max_err, **frame,
            "bound_by": "+".join(sorted(bound_by))}


def phase_flagship(config, model):
    from dpft_tpu_torch.utils.example import example_batch

    batch = _to_cuda(example_batch(config, B=1, cam_hw=(512, 910)))
    with torch.inference_mode():
        out = model(batch)
        with _plain_core_eager():
            ref = model(batch)
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


RADAR_FLOPS = 6_091_105_532  # one B=1 forward of config/kradar_radar.json


def _graphed(model):
    """The stages of ``model`` that hold a captured graph."""
    from dpft_tpu_torch.models import graphs

    return sum(any(isinstance(g, graphs._Graph)
                   for g in m.__dict__["_graphs"].graphs.values())
               for m in model.modules() if "_graphs" in m.__dict__)


def _held_equal(label, got, want):
    for key in want:
        if not torch.equal(got[key], want[key]):
            err = (got[key] - want[key]).abs().max().item()
            raise AssertionError(f"[graphs] {label}: {key} differs from the "
                                 f"eager forward by up to {err:.3e}")


def phase_graphs(config, model):
    """The eval forward's stages as CUDA graphs (``models/graphs.py``), on
    a copy of the flagship and on config/kradar_radar.json, at B=1 and B=4
    in float32. Held: every stage replays from the third call of a key on,
    bit-equal to the eager forward (held eager by ``_Eager``) under
    ``inference_mode`` and ``no_grad``, with 12 (8) ``msda_fwd`` launches
    counted per forward; outputs held from one call are unchanged by the
    next; after an in-place update of every weight a replay gives the
    eager forward of the new weights; after ``.to()`` (cpu and back) and
    after ``load_state_dict(assign=True)``, with the old tensors kept and
    filled with NaN, the graphs are dropped, the outputs are the eager
    forward's and the stages capture again; FLOPs by the evaluator and by
    hooks are the forward's (155,427,456,252 / 6,091,105,532 at B=1).
    Printed: ms per forward on the host clock, replayed and eager (the
    latter slowed by ``_Eager``'s Python call per operation)."""
    import copy

    from dpft_tpu_torch.evaluation.evaluator import forward_flops
    from dpft_tpu_torch.models import registry
    from dpft_tpu_torch.utils.example import example_batch

    with open(os.path.join(ROOT, "config", "kradar_radar.json")) as f:
        radar_config = json.load(f)
    nets = (("kradar", config, copy.deepcopy(model).eval(), 10,
             155_427_456_252),
            ("kradar_radar", radar_config,
             registry.build(radar_config["model"]["name"], radar_config,
                            device="cuda", seed=0).eval(), 7, RADAR_FLOPS))

    def clone(out):
        return {k: v.clone() for k, v in out.items()}

    def eager(net, batch):
        with _Eager():
            return net(batch)

    for name, cfg, net, stages, flops in nets:
        views = len(cfg["model"]["inputs"])
        for B in (1, 4):
            a, b = (_to_cuda(example_batch(cfg, B=B, cam_hw=(512, 910),
                                           seed=seed)) for seed in (0, 1))
            label = f"{name} B={B}"
            with torch.inference_mode():
                for _ in range(3):
                    net(a)
                if _graphed(net) != stages:
                    raise AssertionError(f"[graphs] {label}: "
                                         f"{_graphed(net)} of {stages} "
                                         "stages captured")
                _reset_launches()
                held = net(a)
                launches = _read_launches()["msda_fwd"]
                kept = clone(held)
                other = net(b)
                _held_equal(f"{label} replay", held, eager(net, a))
                _held_equal(f"{label} replay of other inputs", other,
                            eager(net, b))
                _held_equal(f"{label} held outputs", held, kept)
            want = cfg["model"]["fuser"]["i_iter"] * views
            if launches != want:
                raise AssertionError(f"[graphs] {label}: {launches} msda_fwd "
                                     f"launches counted, expected {want}")
            with torch.no_grad():
                for _ in range(3):
                    net(a)
                _held_equal(f"{label} no_grad replay", net(a), eager(net, a))
            with torch.inference_mode():
                times = {}
                for kind, run in (("replayed", lambda: net(a)),
                                  ("eager", lambda: eager(net, a))):
                    run()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(10):
                        run()
                    torch.cuda.synchronize()
                    times[kind] = (time.perf_counter() - t0) * 100
            print(f"[graphs] {label}: {stages} stages replay, bit-equal to "
                  f"eager under inference_mode and no_grad, held outputs "
                  f"unchanged, {launches} msda_fwd launches per forward; "
                  f"host clock {times['replayed']:.2f} ms per forward "
                  f"replayed, {times['eager']:.2f} eager (under _Eager)")

        views = len(cfg["model"]["inputs"])
        a = _to_cuda(example_batch(cfg, B=1, cam_hw=(512, 910)))
        with torch.no_grad():
            for p in net.parameters():
                p.mul_(1.001)
        with torch.inference_mode():
            _held_equal(f"{name} after an in-place update", net(a),
                        eager(net, a))
        for how in ("to", "assign"):
            old = [t.detach() for t in (*net.parameters(), *net.buffers())]
            if how == "to":
                net.to("cpu").to("cuda")
            else:
                net.load_state_dict({k: v * 1.001 if v.is_floating_point()
                                     else v.clone() for k, v in
                                     net.state_dict().items()}, assign=True)
            with torch.no_grad():
                for t in old:
                    if t.is_floating_point():
                        t.fill_(float("nan"))
            with torch.inference_mode():
                got = net(a)
                dropped = _graphed(net)
                net(a)
                replayed = net(a)
                want = eager(net, a)
            _held_equal(f"{name} after {how}", got, want)
            _held_equal(f"{name} replayed after {how}", replayed, want)
            # The embeddings hold no parameter or buffer: theirs stay.
            if dropped != views or _graphed(net) != stages:
                raise AssertionError(f"[graphs] {name} after {how}: "
                                     f"{dropped} stages kept their graphs, "
                                     f"{_graphed(net)} captured again")
            del old
        counted = (forward_flops(net, a), reckon_flops(net, a))
        if counted != (flops, flops):
            raise AssertionError(f"[graphs] {name}: FLOPs {counted}, "
                                 f"expected {flops}")
        print(f"[graphs] {name}: replay after an in-place update = eager; "
              f"after .to() and load_state_dict(assign=True) the graphs are "
              f"dropped (the old tensors NaN), then captured again; FLOPs "
              f"{flops:,} by the evaluator and by hooks")

    # Every graph is captured into one memory pool: replays of the two
    # models in turns, held, each give its model's eager forward.
    runs = [(name, net, _to_cuda(example_batch(cfg, B=1, cam_hw=(512, 910))))
            for name, cfg, net, _, _ in nets]
    with torch.inference_mode():
        held = [(f"{name} replay {turn} in turns", net, x, net(x))
                for turn in range(2) for name, net, x in runs]
        for label, net, x, got in held:
            _held_equal(label, got, eager(net, x))
    print("[graphs] kradar and kradar_radar replayed in turns from one "
          "memory pool: each held output = its eager forward")
    del nets
    torch.cuda.empty_cache()


def _time_forwards(config, model, label):
    """Latency (CUDA events), peak memory and achieved FLOP/s (the
    evaluator's count of one forward over the event time) of the forward at
    B=1 and B=4 in f32 and bf16. The peak counts whatever else is held on
    the card."""
    from dpft_tpu_torch.evaluation.evaluator import forward_flops
    from dpft_tpu_torch.utils.example import example_batch

    held = torch.cuda.memory_allocated() / 2 ** 30
    model.eval()
    batches = {B: _to_cuda(example_batch(config, B=B, cam_hw=(512, 910)))
               for B in (1, 4)}
    flops = {B: forward_flops(model, batch) for B, batch in batches.items()}
    for dtype in (torch.float32, torch.bfloat16):
        model.compute_dtype = dtype
        for B, batch in batches.items():
            torch.cuda.reset_peak_memory_stats()
            with torch.inference_mode():
                ms = _cuda_ms(lambda: model(batch), reps=20, warmup=3)
                out = model(batch)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            if not all(torch.isfinite(v).all() for v in out.values()):
                raise AssertionError(f"non-finite outputs at B={B} {dtype}")
            print(f"[{label}] B={B} {str(dtype)[6:]}: {ms:.3f} ms/batch, "
                  f"{ms / B:.3f} ms/frame, peak memory {peak:.3f} GiB "
                  f"({held:.3f} GiB held before); {flops[B]:,} FLOPs per "
                  f"forward, {flops[B] / ms / 1e9:.2f} TFLOP/s achieved")
    model.compute_dtype = torch.float32


def phase_launch_counts(config, models):
    """Kernels, copies and memsets that one forward puts on the card, for
    each of ``models`` (label -> model), counted by torch.profiler
    (``profiling.device_activity``). It runs after every timed phase: once
    the profiler has been used, its tracing stays attached and every later
    launch costs the host more."""
    from dpft_tpu_torch.utils import profiling
    from dpft_tpu_torch.utils.example import example_batch

    for dtype in (torch.float32, torch.bfloat16):
        for B in (1, 4):
            batch = _to_cuda(example_batch(config, B=B, cam_hw=(512, 910)))
            counts = {}
            for label, model in models.items():
                model.eval()
                model.compute_dtype = dtype
                with torch.inference_mode():
                    n = profiling.device_activity(lambda: model(batch),
                                                  device="cuda").launches
                model.compute_dtype = torch.float32
                counts[label] = int(n) or "not measured"
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
                    # Kernels only: the operators' own events (dpft::msda_*
                    # and their autograd nodes) sum their kernels' time.
                    if "msda" in event.key and "_kernel" in event.key and \
                            event.device_time_total > 0:
                        name = event.key[event.key.find("msda"):].split("(")[0]
                        cells.append(f"{name} "
                                     f"{event.device_time_total / event.count:.1f}")
                print(f"[kernel times] {view} B={B} f32 {backend}, us per "
                      f"launch: {', '.join(sorted(cells)) or 'not measured'}")


def grid_sample_core(value, shapes, loc, att):
    """The reference's own PyTorch MSDA core: ``F.grid_sample`` (bilinear,
    zeros, align_corners=False) on each level, times the attention, summed
    over levels and points. One call computes what ``msda_fwd`` computes:
    the library call of rows 1 / 1b. Timed only; the port never calls it."""
    B, _, H, D = value.shape
    N, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    levels = value.split([h * w for h, w in shapes], dim=1)
    grids = 2 * loc - 1
    sampled = []
    for lvl, (h, w) in enumerate(shapes):
        image = levels[lvl].flatten(2).transpose(1, 2).reshape(B * H, D, h, w)
        grid = grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1)
        sampled.append(torch.nn.functional.grid_sample(
            image, grid.to(value.dtype), mode="bilinear",
            padding_mode="zeros", align_corners=False))   # (B*H, D, N, P)
    weights = att.transpose(1, 2).reshape(B * H, 1, N, L * P)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * weights).sum(-1)
    return out.view(B, H * D, N).transpose(1, 2).contiguous()


def phase_msda_call_times(view_shapes):
    """One MSDA call of each view through ``msda_fwd`` and ``msda_bwd`` at
    B=1 and B=4: ms by CUDA events and the card's own time by the profiler,
    the backward's fills and casts included, beside the bound of the call
    (forward: sampled value sectors, locations, weights read once and the
    output written once, or 10 operations per corner and channel; backward:
    those and grad_out read once, d_value written whole, d_loc and d_att
    written once, or 30 operations per corner and channel), and the same
    call through ``grid_sample_core`` (held once against the plain version
    within 1e-4 of its largest element; its forward, and its backward by
    autograd on a kept graph, by events: the library times). Events first:
    the profiler runs after every timed phase, as ``phase_kernel_times``.
    The profiler's side is ``profiling.device_activity`` over 10 calls.
    Returns the library times in ms by (fwd / bwd, view, B), float32."""
    from dpft_tpu_torch.ops import deform_attn as da
    from dpft_tpu_torch.utils import profiling

    cells, library = {}, {}
    for view, shapes in view_shapes.items():
        for B in (B1, B_TRAIN):
            value, loc, att = _msda_inputs(shapes, B, N_QUERIES, HEADS,
                                           HEAD_DIM, POINTS, torch.float32,
                                           -0.2, 1.2, seed=6)
            grad = torch.randn(B, N_QUERIES, HEADS * HEAD_DIM, device="cuda",
                               generator=torch.Generator("cuda").manual_seed(7))
            sampled = _msda_value_bytes(value, shapes, loc)
            out_bytes = B * N_QUERIES * HEADS * HEAD_DIM * 4
            bounds = (_bound(sampled + _nbytes(loc, att) + out_bytes,
                             da.msda_operations(att.shape, HEAD_DIM)),
                      _bound(sampled + 2 * _nbytes(loc, att) + out_bytes
                             + _nbytes(value),
                             da.msda_operations(att.shape, HEAD_DIM,
                                                backward=True)))
            calls = {}
            for dtype in (torch.float32, torch.bfloat16):
                args = (value.to(dtype), shapes, loc, att.to(dtype))
                g = grad.to(dtype)
                calls["fwd", dtype] = lambda args=args: da.msda_fwd(*args)
                calls["bwd", dtype] = lambda args=args, g=g: da.msda_bwd(
                    *args, g)
            with torch.inference_mode():
                events = {k: _cuda_ms(fn, reps=50) for k, fn in calls.items()}
                want = da.ms_deform_attn_core_plain(value, shapes, loc, att)
                got = grid_sample_core(value, shapes, loc, att)
                # grid_sample takes the location as 2 loc - 1 and maps it
                # back: float32 rounding moves a point by up to 1e-7 of the
                # map's side (5e-5 pixel on 910 columns).
                err = (got - want).abs().max().item()
                if not err <= 1e-4 * want.abs().max().item():
                    raise AssertionError(f"grid_sample_core {view} B={B}: "
                                         f"err {err:.3e}")
                library["fwd", view, B] = _cuda_ms(
                    lambda: grid_sample_core(value, shapes, loc, att))
            inputs = [t.clone().requires_grad_() for t in (value, loc, att)]
            out = grid_sample_core(inputs[0], shapes, *inputs[1:])
            library["bwd", view, B] = _cuda_ms(lambda: torch.autograd.grad(
                out, inputs, grad, retain_graph=True))
            del out, inputs
            cells[view, B] = (calls, events, bounds)
    for (view, B), (calls, events, bounds) in cells.items():
        parts = []
        for (what, dtype), fn in calls.items():
            with torch.inference_mode():
                act = profiling.device_activity(fn, reps=10, device="cuda")
            split = ", ".join(f"{n} {1e3 * t:.1f}"
                              for n, t in sorted(act.kernel_ms.items()))
            parts.append(f"{what} {str(dtype)[6:]} {events[what, dtype]:.4f} "
                         f"ms by events, {1e3 * act.busy_ms:.1f} us on the "
                         f"card ({split})")
        (f_ms, f_by), (b_ms, b_by) = bounds
        print(f"[msda calls] {view} B={B}: {'; '.join(parts)}; bound (f32) "
              f"fwd {1e3 * f_ms:.2f} us ({f_by}), bwd {1e3 * b_ms:.2f} us "
              f"({b_by}); grid_sample core (f32, the library call) fwd "
              f"{library['fwd', view, B]:.4f} ms, bwd "
              f"{library['bwd', view, B]:.4f} ms by events")
    return library


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


def reckon_flops(model, batch):
    """FLOPs of one forward of ``model`` on ``batch``, reckoned apart from
    the evaluator's counter: forward hooks give 2 x the multiply-adds of
    every ``nn.Conv2d``, ``nn.Linear`` and ``Unary1d``, of the in-projections
    and the two batched products of every ``MultiheadAttention`` (which
    calls ``F.linear`` and ``torch.matmul`` itself), the two batched
    products of every Swin ``ShiftedWindowAttention`` over its padded
    windows, and per ``MSDeformAttn`` call the MSDA formula of its sampling
    points."""
    from torch import nn

    from dpft_tpu_torch.models.backbones.swin import (WINDOW,
                                                       ShiftedWindowAttention)
    from dpft_tpu_torch.models.layers.attention import MultiheadAttention
    from dpft_tpu_torch.models.layers.ms_deform_attn import MSDeformAttn
    from dpft_tpu_torch.models.layers.unary import Unary1d
    from dpft_tpu_torch.ops.deform_attn import msda_operations

    counts = []

    def conv(m, args, out):
        taps = m.in_channels // m.groups * math.prod(m.kernel_size)
        counts.append(2 * out.numel() * taps)

    def linear(m, args, out):
        counts.append(2 * out.numel() * args[0].shape[-1])

    def attention(m, args, out):
        q, k, v = args
        B, N, M, E = q.shape[0], q.shape[1], k.shape[1], m.embed_dim
        counts.append(2 * B * E * (N * q.shape[-1] + M * k.shape[-1]
                                   + M * v.shape[-1]) + 4 * B * N * M * E)

    def window_attention(m, args, out):
        B, H, W, C = args[0].shape
        windows = B * -(-H // WINDOW) * -(-W // WINDOW)
        counts.append(4 * windows * WINDOW ** 4 * C)

    def msda(m, args, out):
        B, N = args[0].shape[:2]
        counts.append(msda_operations(
            (B, N, m.n_heads, m.n_levels, m.n_points), m.d_model // m.n_heads))

    hooks = {nn.Conv2d: conv, nn.Linear: linear, Unary1d: linear,
             MultiheadAttention: attention, MSDeformAttn: msda,
             ShiftedWindowAttention: window_attention}
    handles = [m.register_forward_hook(hooks[type(m)])
               for m in model.modules() if type(m) in hooks]
    try:
        with torch.inference_mode():
            model(batch)
    finally:
        for handle in handles:
            handle.remove()
    return sum(counts)


def family_config(config, backbone, learnable=False, multi_scale=None):
    """``config`` with every view's backbone ``backbone`` (at
    ``multi_scale`` stages where given), each neck's ``in_channels_list``
    set to the skip level's channels and the backbone's stage widths and
    the embeddings' and the fuser's levels to match; with ``learnable`` the
    learnable querent, one query per fuser query, within the static
    querent's minimum and maximum."""
    from dpft_tpu_torch.models.backbones import stage_channels

    config = json.loads(json.dumps(config))
    model = config["model"]
    for view, bcfg in model["backbones"].items():
        bcfg["name"] = backbone
        bcfg["multi_scale"] = multi_scale or bcfg["multi_scale"]
        skip = ([bcfg.get("in_channels", 3)]
                if model.get("skiplinks", {}).get(view) else [])
        channels = skip + list(stage_channels(backbone)[:bcfg["multi_scale"]])
        model["necks"][view]["in_channels_list"] = channels
        model["embeddings"][view]["n_levels"] = len(channels)
    model["fuser"]["n_levels"] = [len(model["necks"][v]["in_channels_list"])
                                  for v in model["inputs"]]
    if learnable:
        static = model["querent"]
        model["querent"] = {"name": "learnable_query",
                            "n_queries": model["fuser"]["n_queries"],
                            "minimum": static["minimum"],
                            "maximum": static["maximum"]}
    return config


def reference_extras():
    """What a real reference pickle may hold beside tensors: a
    ``torch.device``, a ``functools.partial``, a numpy array and
    ``torch.nn.functional.relu`` as attributes."""
    import functools

    return {"device": torch.device("cuda", 0),
            "scale": functools.partial(torch.nn.functional.relu,
                                       inplace=False),
            "anchors": np.arange(6, dtype=np.float32).reshape(2, 3),
            "activation": torch.nn.functional.relu}


def write_reference_pickle(model, path, extras=None):
    """Writes ``model`` as the reference saves a checkpoint
    (``torch.save(model, path)``, a pickle of the module tree) with none of
    the port's classes in it: each is replaced by a class of its name under
    a ``dprt.*`` module (``dpft_tpu_torch.models.dpft`` becomes
    ``dprt.models.dpft``), which exists only while the file is written, so
    that no loader can import it; torch's own modules stay. A module of
    the port keeps its parameters, buffers, children and attributes of
    plain types (no cache of tensors);
    ``extras`` (a dict) become attributes of the root (see
    :func:`reference_extras`). Returns the globals the file names."""
    import copy
    import types

    from torch import nn

    plain = (bool, int, float, str, tuple, list, set, type(None))
    internals = set(nn.Module().__dict__)    # parameters, buffers, children
    made = {}

    def stub_class(cls):
        name = "dprt" + cls.__module__[len("dpft_tpu_torch"):]
        if (name, cls.__name__) not in made:
            made[name, cls.__name__] = type(cls.__name__, (nn.Module,),
                                            {"__module__": name})
        return made[name, cls.__name__]

    def clone(m):
        if type(m).__module__.startswith("dpft_tpu_torch"):
            new = object.__new__(stub_class(type(m)))
            new.__dict__.update({k: v for k, v in m.__dict__.items()
                                 if k in internals or isinstance(v, plain)})
        else:
            new = copy.copy(m)
        new._modules = {k: clone(c) for k, c in m._modules.items()}
        return new

    root = clone(model)
    root.__dict__.update(extras or {})
    # The dprt.* modules and their parents, while pickle looks them up.
    names = {".".join(name.split(".")[:i + 1]) for name, _ in made
             for i in range(name.count(".") + 1)}
    for name in names:
        sys.modules[name] = types.ModuleType(name)
    for (name, cls_name), cls in made.items():
        setattr(sys.modules[name], cls_name, cls)
    try:
        torch.save(root, path)
    finally:
        for name in names:
            del sys.modules[name]
    return torch.serialization.get_unsafe_globals_in_checkpoint(path)


class _Reduces:
    """Pickles as a call of ``fn`` on ``args``: what a malicious checkpoint
    holds."""

    def __init__(self, fn, *args):
        self.fn, self.args = fn, args

    def __reduce__(self):
        return self.fn, self.args


def write_malicious_pickles(directory, marker):
    """Two checkpoints that would create the file ``marker`` when
    unpickled: one REDUCEs ``os.system``, one ``builtins.exec`` beside a
    tensor. Returns their paths."""
    import builtins

    paths = []
    for name, payload in (
            ("system", _Reduces(os.system, f"touch {marker}")),
            ("exec", _Reduces(builtins.exec,
                              f"open({marker!r}, 'w').close()"))):
        os.makedirs(os.path.join(directory, name), exist_ok=True)
        path = os.path.join(directory, name,
                            "2026-01-01-00-00-00_checkpoint_0001.pt")
        torch.save({"weight": torch.ones(2), "payload": payload}, path)
        paths.append(path)
    return paths


def phase_serve(config, model, view_shapes, label="serve"):
    """The serving path; returns its launches of every kernel and the
    FLOPs per forward that the evaluator reports."""
    from dpft_tpu_torch.evaluation import CentralizedEvaluator
    from dpft_tpu_torch.models import registry

    loader = _Loader(config)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "run", "2026-01-01-00-00-00_checkpoint_0001.pt")
        registry.save(model, config, ckpt)
        evaluator = CentralizedEvaluator.from_config(config, device="cuda",
                                                     repetitions=REPS)
        dst = os.path.join(tmp, "log")
        _reset_launches()
        results = evaluator(ckpt, loader, dst)
        launches = _read_launches()
        tree = os.path.join(dst, "2026-01-01-00-00-00", "exports", "kradar")
        files = [os.path.join(d, f) for d, _, fs in os.walk(tree) for f in fs]
        for sub in ("preds", "gts", "desc"):
            if not os.path.isfile(os.path.join(tree, "0.0", "all", sub,
                                               "000001.txt")):
                raise AssertionError(f"exporter wrote no {sub}/000001.txt")
        with open(os.path.join(dst, "2026-01-01-00-00-00",
                               "results.json")) as f:
            written = json.load(f)
    # 2 batches + warm-up + timed forwards + the FLOP count's forward (in
    # the model's own form since the matmul form is an operator too);
    # serving runs no backward and reduces no radar cube.
    expected = _expected_launches(config, view_shapes,
                                  2 + evaluator.warmup + REPS + 1, 0)
    if launches != expected:
        raise AssertionError(f"the {label} path launched {launches}, "
                             f"expected {expected}")
    reckoned = reckon_flops(model, _to_cuda(loader.batches[0][0]))
    params = sum(p.numel() for p in model.parameters())
    if (results["FLOPS"], results["Parameters"]) != (reckoned, params) or \
            {k: written[k] for k in ("FLOPS", "Parameters")} != \
            {"FLOPS": reckoned, "Parameters": params}:
        raise AssertionError(f"the {label} path reports FLOPS "
                             f"{results['FLOPS']} and Parameters "
                             f"{results['Parameters']} ({written}); reckoned "
                             f"by hooks {reckoned} and {params}")
    print(f"[{label}] save -> load -> evaluate -> export: {len(files)} files; "
          f"results {json.dumps(results)}; FLOPS = {reckoned:,} per B=1 "
          f"forward, as reckoned by hooks, and in results.json; launches "
          f"{launches}")
    return launches, results["FLOPS"]


# Run in a fresh interpreter by phase_export: it loads the exported
# programs with torch and the MSDA operators only, runs each on the saved
# batches on the card, and reports per program the load time, the launches
# of every forward, the ms per forward by CUDA events, the outputs, and what
# one forward puts on the card by torch.profiler. The radar wrappers live in
# a module this process never imports: no launch.
_LOAD_AND_RUN = """
import json, sys, time
import torch
import dpft_tpu_torch.ops.deform_attn as da

# Full float32, as the CLIs run (utils/device.py:use_full_float32): the
# flags belong to the process, not to the program.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
tmp, names, reps = sys.argv[1], sys.argv[2].split(","), int(sys.argv[3])
wrappers = da.LAUNCH_COUNTED
batches = torch.load(tmp + "/batches.pt")
for w in wrappers.values():
    w.launches = 0
report, outputs = {}, {}
for name in names:
    t0 = time.perf_counter()
    forward = torch.export.load(f"{tmp}/{name}.pt2").module()
    load_s = time.perf_counter() - t0
    per_forward = []
    with torch.inference_mode():
        for seed, batch in batches.items():
            before = {k: w.launches for k, w in wrappers.items()}
            outputs[name, seed] = {k: v.float().cpu()
                                   for k, v in forward(batch).items()}
            per_forward.append({k: w.launches - before[k]
                                for k, w in wrappers.items()})
        batch = batches["seed0"]
        for _ in range(3):
            forward(batch)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            forward(batch)
        end.record()
        torch.cuda.synchronize()
    report[name] = {"load_s": load_s, "per_forward": per_forward,
                    "forwards": len(batches) + 3 + reps,
                    "ms": start.elapsed_time(end) / reps}
report["launches"] = {k: w.launches for k, w in wrappers.items()}
# Last, since the profiler slows every later launch: what one forward of
# each program puts on the card (kernels, copies, memsets).
from torch.profiler import ProfilerActivity, profile
for name in names:
    forward = torch.export.load(f"{tmp}/{name}.pt2").module()
    with torch.inference_mode():
        forward(batches["seed0"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            forward(batches["seed0"])
            torch.cuda.synchronize()
    report[name]["device_launches"] = sum(
        e.device_type == torch.autograd.DeviceType.CUDA
        for e in prof.events())
report["models_imported"] = sorted(m for m in sys.modules
                                   if m.startswith("dpft_tpu_torch.models"))
torch.save(outputs, tmp + "/outputs.pt")
print(json.dumps(report))
"""


def _msda_nodes(program):
    """Targets of the MSDA nodes of an exported program, its autocast
    regions included."""
    return [str(node.target) for gm in program.graph_module.modules()
            if isinstance(gm, torch.fx.GraphModule)
            for node in gm.graph.nodes
            if "msda" in str(node.target) or "gather" in str(node.target)]


def _shared_storages(program):
    """Names of the program's weights and constants that share a storage
    with another, grouped (what ``torch.export.save`` writes once)."""
    groups = {}
    for key, t in (*program.state_dict.items(), *program.constants.items()):
        if isinstance(t, torch.Tensor):
            groups.setdefault(t.untyped_storage().data_ptr(), []).append(key)
    return [names for names in groups.values() if len(names) > 1]


def phase_export(config, model, view_shapes, label="export",
                 dtypes=("float32", "bfloat16")):
    """The export path (the sixth main path; under ``"mm"`` the seventh,
    ``export_mm``): the flagship model at B=1 in each of ``dtypes``
    through ``export_forward`` and ``save_exported``; a fresh interpreter
    that imports torch and the MSDA operators only loads the programs and
    runs them on the card on the batches of seed 0 and seed 1. Outputs
    within 1e-5 (f32) and 2e-2 (bf16) of each output's largest element of
    the eager forward; one node of the model's MSDA operator
    (``dpft.msda_fwd``, under ``"mm"`` ``dpft.msda_mm_fwd``) per view and
    iteration; every forward launches exactly what the eager forward does
    (``_expected_launches``); returns the launches of every kernel."""
    from dpft_tpu_torch.export import export_forward, save_exported
    from dpft_tpu_torch.models.fusers.mpfusion import msda_backend_from_config
    from dpft_tpu_torch.utils.example import example_batch

    fuser = config["model"]["fuser"]
    op = ("msda_mm_fwd" if msda_backend_from_config(fuser) == "mm"
          else "msda_fwd")
    calls = fuser["i_iter"] * len(view_shapes)
    per_forward = {k: v for k, v in _expected_launches(
        config, view_shapes, 1, 0).items() if k.startswith("msda")}
    batches = {f"seed{seed}": _to_cuda(example_batch(
        config, B=1, cam_hw=(512, 910), seed=seed)) for seed in (0, 1)}
    tol = {"float32": TOL[torch.float32], "bfloat16": TOL[torch.bfloat16]}
    eager, eager_ms, seconds, shared = {}, {}, {}, {}
    model.eval()    # what export_forward traces; a train step leaves train

    with tempfile.TemporaryDirectory() as tmp:
        torch.save(batches, os.path.join(tmp, "batches.pt"))
        for name in dtypes:
            dtype = getattr(torch, name)
            model.compute_dtype = dtype
            with torch.inference_mode():
                for seed, batch in batches.items():
                    eager[name, seed] = {k: v.float().cpu()
                                         for k, v in model(batch).items()}
                eager_ms[name] = _cuda_ms(
                    lambda: model(batches["seed0"]), reps=20, warmup=3)
            _reset_launches()
            t0 = time.perf_counter()
            program = export_forward(model, batches["seed0"])
            t1 = time.perf_counter()
            save_exported(program, os.path.join(tmp, f"{name}.pt2"))
            seconds[name] = (t1 - t0, time.perf_counter() - t1)
            shared[name] = _shared_storages(program)
            if any(_read_launches().values()):
                raise AssertionError(f"export launched {_read_launches()}: "
                                     "tracing must reach no kernel")
            nodes = _msda_nodes(program)
            if nodes != [f"dpft.{op}.default"] * calls:
                raise AssertionError(f"{name} program: MSDA nodes {nodes}")
            regions = [n.args[1:3] for n in program.graph.nodes
                       if "autocast" in str(n.target)]
            if dtype == torch.bfloat16 and (torch.bfloat16, True) not in \
                    regions:
                raise AssertionError(f"no bfloat16 autocast region in the "
                                     f"graph: {regions}")
        model.compute_dtype = torch.float32

        proc = subprocess.run(
            [sys.executable, "-c", _LOAD_AND_RUN, tmp, ",".join(dtypes),
             "20"], cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"loading the programs failed:\n"
                                 f"{proc.stderr[-4000:]}")
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        loaded = torch.load(os.path.join(tmp, "outputs.pt"))
    if report["models_imported"]:
        raise AssertionError(f"loading imported {report['models_imported']}")
    forwards = 0
    for name in dtypes:
        run = report[name]
        if any(n != per_forward for n in run["per_forward"]):
            raise AssertionError(f"{name} program launched "
                                 f"{run['per_forward']} per forward, expected "
                                 f"{per_forward}")
        forwards += run["forwards"]
        errs, same = [], True
        for seed in batches:
            for key, want in eager[name, seed].items():
                got = loaded[name, seed][key]
                scale = want.abs().max().item()
                err = (got - want).abs().max().item()
                if got.shape != want.shape or not err <= tol[name] * scale:
                    raise AssertionError(
                        f"{name} program {seed} {key}: max abs err {err:.3e} "
                        f"exceeds {tol[name]} of its largest element {scale}")
                errs.append(err / max(scale, 1e-30))
                same = same and torch.equal(got, want)
        export_s, save_s = seconds[name]
        print(f"[{label}] flagship B=1 {name}: export {export_s:.2f} s, save "
              f"{save_s:.2f} s, load in a fresh process {run['load_s']:.2f} s "
              f"(torch and the MSDA operators only, no "
              f"dpft_tpu_torch.models); loaded program {run['ms']:.3f} ms per "
              f"forward by CUDA events against the eager forward's "
              f"{eager_ms[name]:.3f} ({run['device_launches']} kernels, "
              f"copies and memsets on the card per forward); seeds 0 and 1: "
              f"worst error "
              f"{max(errs):.3e} of an output's largest element (tol "
              f"{tol[name]}), bit-equal: {same}; {calls} "
              f"dpft.{op} nodes, launches per forward "
              f"{run['per_forward'][0]}; weights and constants that share a "
              f"storage: {shared[name] or 'none'}, ok")
    launches = dict.fromkeys(KERNELS, 0)
    launches.update(report["launches"])
    expected = _expected_launches(config, view_shapes, forwards, 0)
    if launches != expected:
        raise AssertionError(f"the {label} path launched {launches}, "
                             f"expected {expected}")
    print(f"[{label}] launches over {forwards} forwards of the loaded "
          f"programs: {launches}")
    return launches


def _plain_grads(value, shapes, loc, att, grad_out):
    from dpft_tpu_torch.ops import deform_attn as da

    inputs = [t.detach().float().requires_grad_(True)
              for t in (value, loc, att)]
    out = da.ms_deform_attn_core_plain(inputs[0], shapes, *inputs[1:])
    return torch.autograd.grad(out, inputs, grad_out.float())


def _same_bits_twice(what, args, got):
    """``msda_bwd`` on ``args`` once more, and the gradients of the
    operator ``dpft::msda_fwd`` twice by autograd (its backward is
    ``dpft::msda_bwd``), must give the bits of ``got``."""
    from dpft_tpu_torch.ops import deform_attn as da

    value, shapes, loc, att, grad_out = args
    runs = {"msda_bwd again": da.msda_bwd(*args)}
    for k in ("once", "twice"):
        leaves = [t.detach().requires_grad_(True) for t in (value, loc, att)]
        out = da.ms_deform_attn_core(leaves[0], shapes, *leaves[1:])
        runs[f"dpft::msda_fwd {k}"] = torch.autograd.grad(out, leaves,
                                                          grad_out)
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
                  "again and twice through dpft::msda_fwd, ok")
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
                da.msda_operations(att.shape, D, backward=True))
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
    kernels' own bits are held in phase 6. Then the same with
    ``torch.backends.cudnn.deterministic`` on (cuDNN's share of the
    spread), and the step's ms (CUDA events, no update) with the flag off
    and on; the flag is set back off."""
    from dpft_tpu_torch.training import CentralizedTrainer

    trainer = CentralizedTrainer.from_config(config)
    batch, targets = _cuda_batch(config, seed=20)
    try:
        for deterministic in (False, True):
            torch.backends.cudnn.deterministic = deterministic
            _backward_twice(trainer, model, batch, targets,
                            f"cudnn.deterministic {deterministic}")

            def step():
                trainer.train_step(model, batch, targets)
                model.zero_grad(set_to_none=True)

            ms = _cuda_ms(step, reps=3, warmup=1)
            print(f"[train] B={B_TRAIN} f32 step (forward, matching, loss, "
                  f"backward; no update) with cudnn.deterministic "
                  f"{deterministic}: {ms:.3f} ms (CUDA events, 3 after 1)")
    finally:
        torch.backends.cudnn.deterministic = False


def _backward_twice(trainer, model, batch, targets, label):
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
    worst = max(differ.values(), default=0.0)
    print(f"[train] B={B_TRAIN} f32 step, backward twice on one forward, "
          f"{label}: {len(differ)} of {len(names)} parameter gradients "
          f"differ (worst {worst:.3e} of its max); of the "
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


DP_RANKS = 2  # gloo ranks that share the one card in phase_data_parallel


def _dp_config(config):
    """The flagship config with dropout 0: each rank of a data-parallel
    step draws its own dropout masks, so only without dropout is the step
    the single-process step on the same rows."""
    config = json.loads(json.dumps(config))
    config["model"]["fuser"]["dropout"] = 0.0
    return config


def _rows(tree, rank, world):
    per = next(iter(tree.values())).shape[0] // world
    return {k: v[rank * per:(rank + 1) * per] for k, v in tree.items()}


def _bn_stats(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _dp_parity_step(trainer, net, model, batch, targets):
    """One train step from cleared gradients: (loss, gradients gathered
    whole (``_gather_whole``), BatchNorm running statistics after it)."""
    model.zero_grad(set_to_none=True)
    torch.manual_seed(3)
    loss = trainer.train_step(net, batch, targets)["loss"]
    grads = {k: _gather_whole(p.grad.detach()).clone()
             for k, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss, grads, _bn_stats(model)


def _compare_stats(what, stats, ref, tol=1e-3):
    """BatchNorm running statistics, each buffer within ``tol`` of its
    largest element."""
    if stats.keys() != ref.keys():
        raise AssertionError(f"{what}: other BatchNorm buffers")
    worst = max((((stats[k] - v).abs().max() / v.abs().max().clamp_min(
        1e-30)).item(), k) for k, v in ref.items())
    if not worst[0] <= tol:
        raise AssertionError(f"{what}: running statistics of {worst[1]}: "
                             f"err {worst[0]:.3e} of its max exceeds {tol}")
    print(f"[data_parallel] {what}: {len(ref)} BatchNorm running statistics,"
          f" worst {worst[0]:.3e} of its max at {worst[1]} (tol {tol}) ok")


def _timed_steps(trainer, net, model, batch, targets, steps=5, warmup=2):
    """(mean ms, std ms, peak GiB, GiB above what the process held before)
    of train steps (forward, matching, loss, metric, backward, AdamW) by
    CUDA events."""
    optimizer = trainer.optimizer_factory(model.parameters())
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(warmup + steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.train_step(net, batch, targets)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        end.record()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    return (float(np.mean(times)), float(np.std(times)), peak / 2 ** 30,
            (peak - held) / 2 ** 30)


def _dp_model(config, dtype=torch.float32):
    """The flagship model from seed 0 on the card in ``dtype``; in float64
    with the plain MSDA core (the kernels take float32 and bfloat16)."""
    import dpft_tpu_torch.models.layers.ms_deform_attn as msda_layer
    from dpft_tpu_torch.models import registry
    from dpft_tpu_torch.ops import deform_attn as da

    msda_layer.ms_deform_attn_core = (_plain_core if dtype == torch.float64
                                      else da.ms_deform_attn_core)
    return registry.build(config["model"]["name"], config, device="cuda",
                          seed=0).to(dtype)


def _in_dtype(tree, dtype):
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in tree.items()}


def _recording_core(calls, core, move=None):
    """``core`` that appends to ``calls`` each call's inputs (value,
    shapes, sampling locations, attention weights) and, once the backward
    has run, its output gradient; with ``move``, the sampling locations
    go through ``move`` first."""
    def recorded(value, shapes, loc, att, backend="gather"):
        if move is not None:
            loc = move(loc)
        out = core(value, shapes, loc, att, backend)
        call = {"args": (value.detach(), shapes, loc.detach(), att.detach())}
        calls.append(call)
        if out.requires_grad:
            out.register_hook(
                lambda g: call.__setitem__("grad_out", g.detach()))
        return out
    return recorded


def _ulp_move(seed):
    """Moves every sampling coordinate by one float32 ulp, up or down at
    random (the gradient passes through unchanged)."""
    gen = torch.Generator("cuda").manual_seed(seed)

    def move(loc):
        up = torch.rand(loc.shape, generator=gen, device=loc.device) < 0.5
        to = torch.where(up, math.inf, -math.inf).to(loc.dtype)
        return loc + (torch.nextafter(loc.detach(), to) - loc.detach())
    return move


def _location_moves(calls, ref_calls):
    """(points, points whose float32 sampling location differs from the
    reference's, points among them that land in another pixel cell, i.e.
    whose bilinear corners change) over all MSDA calls of two forwards."""
    if len(calls) != len(ref_calls):
        raise AssertionError(f"{len(calls)} MSDA calls against "
                             f"{len(ref_calls)}")
    points = moved = crossed = 0
    for call, ref in zip(calls, ref_calls):
        shapes, loc, ref_loc = call["args"][1], call["args"][2], \
            ref["args"][2]
        points += loc[..., 0].numel()
        moved += (loc != ref_loc).any(-1).sum().item()
        for lvl, (h, w) in enumerate(shapes):
            size = torch.tensor([w, h], dtype=torch.float32,
                                device=loc.device)
            cell, ref_cell = ((t[:, :, :, lvl].float() * size - 0.5).floor()
                              for t in (loc, ref_loc))
            crossed += (cell != ref_cell).any(-1).sum().item()
    return points, moved, crossed


def _hold_calls(calls):
    """Holds ``msda_fwd`` and ``msda_bwd`` on every recorded call's own
    inputs and output gradient against the plain version, at phase 1's
    and phase 6's float32 tolerances; returns the largest errors."""
    from dpft_tpu_torch.ops import deform_attn as da

    worst = dict.fromkeys(("msda_fwd", "d_value", "d_loc", "d_att"), 0.0)
    for i, call in enumerate(calls):
        value, shapes, loc, att = call["args"]
        if "grad_out" not in call:
            raise AssertionError(f"MSDA call {i} got no output gradient")
        with torch.inference_mode():
            got = da.msda_fwd(value, shapes, loc, att)
            want = da.ms_deform_attn_core_plain(value, shapes, loc, att)
        tol = TOL[torch.float32]
        worst["msda_fwd"] = max(worst["msda_fwd"],
                                (got - want).abs().max().item())
        if not torch.allclose(got, want, atol=tol, rtol=tol):
            raise AssertionError(f"msda_fwd, MSDA call {i} of the step: max"
                                 f" abs err {worst['msda_fwd']:.3e}")
        grads = da.msda_bwd(value, shapes, loc, att, call["grad_out"])
        wants = _plain_grads(value, shapes, loc, att, call["grad_out"])
        for name, g, w in zip(("d_value", "d_loc", "d_att"), grads, wants):
            err = (g - w).abs().max().item()
            bound = BWD_TOL[torch.float32] * (1.0 + w.abs().max().item())
            if not err <= bound:
                raise AssertionError(f"msda_bwd {name}, MSDA call {i} of "
                                     f"the step: max abs err {err:.3e} "
                                     f"exceeds {bound:.3e}")
            worst[name] = max(worst[name], err)
    return worst


def _dp_evaluate(config, model, batch, targets):
    """The evaluator's metrics (``evaluate_one_epoch``), forward latency (2
    + 5 forwards) and FLOPs on one batch of host rows, in eval mode."""
    from dpft_tpu_torch.evaluation import CentralizedEvaluator

    evaluator = CentralizedEvaluator.from_config(config, device="cuda",
                                                 repetitions=5, warmup=2)
    loader = [(batch, targets)]
    model.eval()
    try:
        return {**evaluator.evaluate_one_epoch(model, loader),
                **evaluator.evaluate_inference_time(model, loader),
                **evaluator.evaluate_complexity(model, loader)}
    finally:
        model.train()


def _host_batch(config, seed):
    """``_cuda_batch``'s batch and targets as host arrays."""
    from dpft_tpu_torch.utils.example import example_batch, example_targets

    return (example_batch(config, B=B_TRAIN, cam_hw=(512, 910), seed=seed),
            example_targets(config, B=B_TRAIN, seed=seed))


def _dp_rank(rank, world, store, tmp):
    """One of ``world`` processes on the one card, in a gloo group at the
    file ``store``, on rows ``rank * 4 / world`` of the B=4 batch: the
    evaluator on those rows (float32, the kernels) and its launches; then
    through ``parallel.distribute`` (global BatchNorm, FSDP2 on the (2, 1)
    mesh that it lays the group out as) one float32
    step with the kernels and its launches, ``msda_fwd`` and ``msda_bwd``
    held against the plain version on each MSDA call's own inputs and
    output gradient of that step, its step times and peak memory, and one
    float64 step on the plain core. Writes ``tmp/rank<rank>.pt``."""
    import torch.distributed as dist

    import dpft_tpu_torch.models.layers.ms_deform_attn as msda_layer
    from dpft_tpu_torch import parallel
    from dpft_tpu_torch.ops import deform_attn as da
    from dpft_tpu_torch.training import CentralizedTrainer
    from dpft_tpu_torch.utils.device import use_full_float32

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    use_full_float32()
    try:
        dist.init_process_group("gloo", init_method="file://" + store,
                                world_size=world, rank=rank)
        with open(os.path.join(ROOT, "config", "kradar.json")) as f:
            config = _dp_config(json.load(f))
        trainer = CentralizedTrainer.from_config(config)
        batch, targets = (_rows(t, rank, world)
                          for t in _cuda_batch(config, seed=20))
        result = {}
        for dtype in (torch.float32, torch.float64):
            model = _dp_model(config, dtype)
            calls = []
            if dtype == torch.float32:
                _reset_launches()
                result["eval"] = _dp_evaluate(config, model, *(
                    _rows(t, rank, world)
                    for t in _host_batch(config, seed=20)))
                result["eval_launches"] = _read_launches()
                msda_layer.ms_deform_attn_core = _recording_core(
                    calls, msda_layer.ms_deform_attn_core)
            net = parallel.distribute(model)
            _reset_launches()
            step = _dp_parity_step(trainer, net, model,
                                   _in_dtype(batch, dtype),
                                   _in_dtype(targets, dtype))
            name = str(dtype)[6:]
            result[name] = {
                "loss": step[0], "launches": _read_launches(),
                "grads": {k: v.cpu() for k, v in step[1].items()},
                "stats": {k: v.cpu() for k, v in step[2].items()},
                "types": sorted({type(m).__name__ for m in model.modules()
                                 if isinstance(m, torch.nn.BatchNorm2d)})}
            if dtype == torch.float32:
                msda_layer.ms_deform_attn_core = da.ms_deform_attn_core
                result["kernels"] = (len(calls), _hold_calls(calls))
                del calls
                result["times"] = _timed_steps(trainer, net, model, batch,
                                               targets)
            del net, model
            torch.cuda.empty_cache()
        if rank > 0:  # the gradients are all-reduced: rank 0 has them
            for name in ("float32", "float64"):
                del result[name]["grads"], result[name]["stats"]
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _print_spread(what, step, ref_step, calls, ref_calls):
    """How far a step's gradients are from the float64 reference's, beside
    how many sampling points of its forward moved (printed, not held)."""
    points, moved, crossed = _location_moves(calls, ref_calls)
    (loss, grads), (ref_loss, ref_grads) = step[:2], ref_step[:2]
    if set(grads) != set(ref_grads):
        raise AssertionError(f"{what}: other parameters reached")
    errs = {k: ((g - ref_grads[k]).abs().max()
                / ref_grads[k].abs().max().clamp_min(1e-30)).item()
            for k, g in grads.items()}
    worst = max(errs, key=errs.get)
    offsets = max(v for k, v in errs.items()
                  if k.endswith("sampling_offsets.weight"))
    print(f"[data_parallel] spread, {what} vs the float64 reference: of "
          f"{points} sampling points per forward {moved} at another float32 "
          f"location, {crossed} in another pixel cell; loss rel err "
          f"{abs(loss - ref_loss) / abs(ref_loss):.3e}; worst gradient "
          f"{errs[worst]:.3e} of its max at {worst}, worst "
          f"sampling_offsets.weight {offsets:.3e} (printed, not held)")


def _compare_evaluations(config, view_shapes, ranks, want):
    """Rank 0's evaluation of the gloo ranks against one process's: FLOPs
    and parameters equal, every metric within 1e-4, a latency; rank 1
    returns the latency alone. Rank 0 ran 9 forwards (1 for the metrics,
    7 timed, 1 counted), rank 1 8."""
    got = ranks[0]["eval"]
    latency = {"Inference_time_mean_ms", "Inference_time_std_ms"}
    if set(ranks[1]["eval"]) != latency or set(got) != set(want):
        raise AssertionError(f"evaluations {[r['eval'] for r in ranks]} "
                             f"against {want}")
    for k in ("FLOPS", "Parameters"):
        if got[k] != want[k]:
            raise AssertionError(f"{k}: {got[k]} on the ranks, {want[k]} in "
                                 "one process")
    for k in config["evaluate"]["metrics"]:
        if not abs(got[k] - want[k]) <= 1e-4:
            raise AssertionError(f"{k}: {got[k]} on the ranks, {want[k]} in "
                                 "one process")
    if not got["Inference_time_mean_ms"] > 0:
        raise AssertionError(f"latency {got['Inference_time_mean_ms']}")
    for r, forwards in ((0, 9), (1, 8)):
        launches = ranks[r]["eval_launches"]
        if launches != _expected_launches(config, view_shapes, forwards, 0):
            raise AssertionError(f"gloo rank {r} launched {launches} in its "
                                 f"evaluation ({forwards} forwards)")
    print(f"[data_parallel] evaluate on {DP_RANKS} gloo ranks, "
          f"{B_TRAIN // DP_RANKS} rows each, vs one process, B={B_TRAIN} "
          "f32: " + ", ".join(f"{k} {got[k]:.6g} vs {want[k]:.6g}"
                              for k in want)
          + f" (FLOPS and Parameters equal, metrics within 1e-4; latency of "
          f"the DP forward, 5 after 2); {ranks[0]['eval_launches']['msda_fwd']}"
          " msda_fwd launches on rank 0 (9 forwards) ok")


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_data_parallel(config, view_shapes):
    """Data parallelism on the one card (the train_dp and eval_dp paths).
    The reference is the flagship B=4 step (dropout 0, the model from seed
    0) without a process group, in float32 with the kernels and in float64
    on the plain core, and the evaluator on the same batch in one process.

    (1) A one-rank NCCL group joined through ``init_distributed``'s
    torchrun route: the float32 step through ``parallel.distribute``
    (FSDP2 on the (1, 1) mesh, global BatchNorm) equals the reference
    (loss 1e-4 relative, gradients and running statistics 1e-3 of their
    largest); ms per step without a group, under torch's DDP alone (which
    the port does not use; for comparison) and through ``distribute``.

    (2) ``DP_RANKS`` processes on the one card in a gloo group (NCCL
    refuses two ranks on one card), two rows each. The evaluator on the
    ranks gives the one-process FLOPs and parameters exactly and its
    metrics within 1e-4, with 12 ``msda_fwd`` launches per forward. In
    float64 the loss, all-reduced gradients and running statistics equal
    the float64 reference's within 1e-6 of their largest; in float32 the
    loss within 1e-4 and the running statistics within 1e-3, while the
    gradients are printed, not held: the float32 step without a group is
    itself that far from the float64 one. Each rank holds ``msda_fwd``
    and ``msda_bwd`` on every MSDA call of its float32 step (B=2, its own
    inputs and output gradients) against the plain version, and launched
    each 12 times in that step; ms per step and peak memory per rank.

    (3) Where the float32 spread comes from, in float64 without a group
    (printed, not held): the reference step again; with the sensor inputs
    scaled by 1 + eps z (eps 1e-12 and 1e-10: does the spread grow in
    proportion, as a smooth response does?); with every sampling location
    moved by one float32 ulp. Each against the reference: the gradients'
    spread, and how many sampling points sit at another float32 location
    or in another pixel cell (where the bilinear derivative by the
    location jumps); the same for the float32 step.

    Returns rank 0's launches in its float32 step and in its evaluation.
    """
    import torch.distributed as dist
    from torch.nn.parallel import DistributedDataParallel

    import dpft_tpu_torch.models.layers.ms_deform_attn as msda_layer
    from dpft_tpu_torch import parallel
    from dpft_tpu_torch.ops import deform_attn as da
    from dpft_tpu_torch.training import CentralizedTrainer

    config = _dp_config(config)
    trainer = CentralizedTrainer.from_config(config)
    batch, targets = _cuda_batch(config, seed=20)
    expected = _expected_launches(config, view_shapes, 1, 1)

    model = _dp_model(config)
    eval_ref = _dp_evaluate(config, model, *_host_batch(config, seed=20))
    calls32 = []
    msda_layer.ms_deform_attn_core = _recording_core(calls32,
                                                     da.ms_deform_attn_core)
    ref = _dp_parity_step(trainer, model, model, batch, targets)
    msda_layer.ms_deform_attn_core = da.ms_deform_attn_core
    times = {"no group": _timed_steps(trainer, model, model, batch,
                                      targets)}
    del model
    model64 = _dp_model(config, torch.float64)
    batch64, targets64 = (_in_dtype(t, torch.float64)
                          for t in (batch, targets))

    def nudged(eps):
        gen = torch.Generator("cuda").manual_seed(5)
        return {k: v * (1 + eps * torch.randn(v.shape, generator=gen,
                                              device="cuda", dtype=v.dtype))
                if k in config["model"]["inputs"] else v
                for k, v in batch64.items()}

    probes = {}
    for probe, inputs, move in (
            ("reference", batch64, None), ("reference again", batch64, None),
            *((f"sensor inputs x (1 + {eps:g} z)", nudged(eps), None)
              for eps in (1e-12, 1e-10)),
            ("every location moved by one float32 ulp", batch64,
             _ulp_move(6))):
        calls = []
        msda_layer.ms_deform_attn_core = _recording_core(calls, _plain_core,
                                                         move)
        probes[probe] = (_dp_parity_step(trainer, model64, model64, inputs,
                                         targets64), calls)
    del model64, batch64, targets64
    msda_layer.ms_deform_attn_core = da.ms_deform_attn_core
    ref64, calls64 = probes.pop("reference")
    for probe, (step, calls) in [("float32, the kernels", (ref, calls32)),
                                 *probes.items()]:
        _print_spread(probe, step, ref64, calls, calls64)
    del probes, calls32, calls64
    torch.cuda.empty_cache()

    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
           "LOCAL_WORLD_SIZE": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        parallel.init_distributed(config, "cuda")
        if (dist.get_backend(), dist.get_world_size()) != ("nccl", 1):
            raise AssertionError(f"group {dist.get_backend()} of "
                                 f"{dist.get_world_size()}")
        model = _dp_model(config)
        # torch's DDP, which the port does not use, for comparison.
        net = DistributedDataParallel(model, device_ids=[0],
                                      broadcast_buffers=False,
                                      find_unused_parameters=True)
        times["torch's DDP alone, NCCL, world 1"] = _timed_steps(
            trainer, net, model, batch, targets)
        del net, model
        model = _dp_model(config)
        net = parallel.distribute(model)
        _reset_launches()
        step = _dp_parity_step(trainer, net, model, batch, targets)
        launches = _read_launches()
        if launches != expected:
            raise AssertionError(f"the NCCL step launched {launches}, "
                                 f"expected {expected}")
        _compare_steps("distribute (FSDP2 + global BatchNorm), NCCL world 1",
                       "no group", step[:2], ref[:2])
        _compare_stats("NCCL world 1 vs no group", step[2], ref[2])
        times["distribute (FSDP2 + global BatchNorm), NCCL, world 1"] = \
            _timed_steps(
            trainer, net, model, batch, targets)
        del net, model
    finally:
        parallel.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        codes = _spawn_ranks(_dp_rank, DP_RANKS, tmp, "store")
        if codes != [0] * DP_RANKS:
            raise AssertionError(f"the gloo ranks exited with {codes}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=True) for r in range(DP_RANKS)]

    def on_cpu(step):
        return (step[0], {k: v.cpu() for k, v in step[1].items()},
                {k: v.cpu() for k, v in step[2].items()})

    ref, ref64 = on_cpu(ref), on_cpu(ref64)
    for name, want, tol in (("float64", ref64, 1e-6),
                            ("float32", ref, None)):
        got = ranks[0][name]
        if {r[name]["loss"] for r in ranks} != {got["loss"]}:
            raise AssertionError(
                f"{name}: the ranks' losses {[r[name]['loss'] for r in ranks]}")
        for r, result in enumerate(ranks):
            if result[name]["types"] != ["GlobalBatchNorm2d"]:
                raise AssertionError(f"rank {r}: {result[name]['types']}")
        _compare_steps(f"{DP_RANKS} gloo ranks on one card, {name}",
                       f"no group, {name}", (got["loss"], got["grads"]),
                       want[:2], tol=tol)
        _compare_stats(f"{DP_RANKS} gloo ranks vs no group, {name}",
                       got["stats"], want[2], tol=tol or 1e-3)
    for r, result in enumerate(ranks):
        if result["float32"]["launches"] != expected:
            raise AssertionError(f"gloo rank {r} launched "
                                 f"{result['float32']['launches']}, "
                                 f"expected {expected}")
        n_calls, worst = result["kernels"]
        if n_calls != expected["msda_fwd"]:
            raise AssertionError(f"gloo rank {r} recorded {n_calls} MSDA "
                                 "calls")
        print(f"[data_parallel] gloo rank {r}: msda_fwd and msda_bwd on the "
              f"{n_calls} MSDA calls of its float32 step (B="
              f"{B_TRAIN // DP_RANKS}, its own inputs and output gradients) "
              "against the plain version: max abs err " + ", ".join(
                  f"{k} {v:.3e}" for k, v in worst.items())
              + f" (tol {TOL[torch.float32]} forward, "
              f"{BWD_TOL[torch.float32]} x (1 + max) backward) ok")
        times[f"gloo rank {r} of {DP_RANKS}, {B_TRAIN // DP_RANKS} rows"] = \
            result["times"]
    _compare_evaluations(config, view_shapes, ranks, eval_ref)
    print(f"[data_parallel] launches of each gloo rank in its float32 step: "
          f"{ranks[0]['float32']['launches']} (expected {expected})")
    for name, (ms, std, peak, above) in times.items():
        print(f"[data_parallel] B={B_TRAIN} f32 step, {name}: {ms:.3f} ms "
              f"(std {std:.3f}, 5 steps by CUDA events after 2); peak memory "
              f"{peak:.3f} GiB, {above:.3f} GiB above what the process held "
              f"before")
    return {"train_dp": ranks[0]["float32"]["launches"],
            "eval_dp": ranks[0]["eval_launches"]}


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
    win = da.MM_TILE // 2 + 1
    n_tr, n_tc = da.mm_tile_counts(h, w)
    inside = int((da.mm_bin_index(x, y, h, w) < n_tr * n_tc).sum())
    fwd_ops = inside * D * (2 * win * win + 2 * win)
    rows = sum(da.mm_touches(y, r * da.MM_TILE).long() for r in range(n_tr))
    cols = sum(da.mm_touches(x, c * da.MM_TILE).long() for c in range(n_tc))
    touched = int((rows * cols).sum())             # (sample, d_val tile) pairs
    bwd_ops = (inside * D * (4 * win * win + 8 * win)
               + touched * 2 * da.MM_TILE ** 2 * D)
    return ((_bound(plane + small + out, da.msda_operations((BH, S), D)),
             1e3 * fwd_ops / PEAK_F32_FLOPS),
            (_bound(2 * plane + 2 * small + out,
                    da.msda_operations((BH, S), D, backward=True)),
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


# The backbone families of the JAX package beside ResNet, at the widths
# of their first variant; the ConvNeXt model also takes the learnable
# querent.
FAMILIES = (("convnext", "ConvNeXt_Tiny", True), ("swin", "Swin_T", False),
            ("regnet", "RegNet_Y_400MF", False))


def phase_families(config):
    """config/kradar.json with every view's backbone swapped for each
    family (``family_config``; production shapes, seed 0, no weights file):
    a B=1 f32 forward against the same model with the plain core (1e-5 of
    each output's largest element) with exactly one ``msda_fwd`` launch per
    view and iteration; one B=4 f32 train step against the plain core's
    (``_compare_steps``, 1e-3) with exactly one ``msda_fwd`` and one
    ``msda_bwd`` launch per view and iteration; a B=1 bf16 forward, finite;
    the FLOP count against the reckoning by hooks. Times by CUDA events:
    forward at B=1 and B=4 f32, train step at B=4 f32; peak memory; build
    seconds. Returns the launches of the forward (``serve_<family>``) and
    of the step (``train_<family>``)."""
    paths = {}
    for label, backbone, learnable in FAMILIES:
        fconfig = family_config(config, backbone, learnable=learnable)
        desc = backbone + (" + learnable querent" if learnable else "")
        paths[f"serve_{label}"], paths[f"train_{label}"] = _hold_model(
            "families", label, fconfig, desc)
    return paths


def _hold_model(tag, label, fconfig, desc):
    """One model of ``fconfig`` at production shapes from seed 0, held as
    ``phase_families`` describes; returns the launches of its B=1 forward
    and of its B=4 step."""
    import dpft_tpu_torch.models.layers.ms_deform_attn as msda_layer
    from dpft_tpu_torch.evaluation.evaluator import forward_flops
    from dpft_tpu_torch.models import registry
    from dpft_tpu_torch.ops import deform_attn as da
    from dpft_tpu_torch.training import CentralizedTrainer
    from dpft_tpu_torch.utils.example import example_batch

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = registry.build(fconfig["model"]["name"], fconfig,
                           device="cuda", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    batches = {B: _to_cuda(example_batch(fconfig, B=B, cam_hw=(512, 910)))
               for B in (1, 4)}
    with torch.inference_mode():
        views = model.features(batches[1])
    view_shapes = dict(zip(model.inputs, (shapes for _, shapes in views)))
    calls = fconfig["model"]["fuser"]["i_iter"] * len(view_shapes)

    # B=1 f32 forward: kernels against the plain core.
    with torch.inference_mode():
        _reset_launches()
        out = model(batches[1])
        fwd_launches = _read_launches()
        with _plain_core_eager():
            ref = model(batches[1])
    expected = _expected_launches(fconfig, view_shapes, 1, 0)
    if fwd_launches != expected or fwd_launches["msda_fwd"] != calls:
        raise AssertionError(f"{desc} forward launched "
                             f"{fwd_launches}, expected {expected}")
    errs = []
    for key, width in (("class", 2), ("center", 3), ("size", 3),
                       ("angle", 2)):
        got, want = out[key], ref[key]
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        if tuple(got.shape) != (1, N_QUERIES, width) or \
                not torch.isfinite(got).all() or \
                not err <= TOL[torch.float32] * scale:
            raise AssertionError(f"{desc} {key}: shape "
                                 f"{tuple(got.shape)}, max abs err "
                                 f"{err:.3e} of {scale}")
        errs.append(err / max(scale, 1e-30))

    # B=1 bf16 forward: finite, through the same kernels as f32, its
    # distance from f32 printed.
    model.compute_dtype = torch.bfloat16
    with torch.inference_mode():
        _reset_launches()
        low = model(batches[1])
        bf16_launches = _read_launches()
    model.compute_dtype = torch.float32
    if not all(torch.isfinite(v).all() for v in low.values()):
        raise AssertionError(f"{desc}: non-finite bf16 outputs")
    if bf16_launches != fwd_launches:
        raise AssertionError(f"{desc} bf16 forward launched "
                             f"{bf16_launches}, f32 {fwd_launches}")
    bf16_err = max(((low[k].float() - out[k]).abs().max()
                    / out[k].abs().max().clamp_min(1e-30)).item()
                   for k in out)

    # The FLOP count against the reckoning by hooks.
    flops = forward_flops(model, batches[1])
    reckoned = reckon_flops(model, batches[1])
    if flops != reckoned:
        raise AssertionError(f"{desc}: FLOPs {flops}, reckoned "
                             f"{reckoned}")

    # One B=4 f32 train step against the plain core's.
    trainer = CentralizedTrainer.from_config(fconfig)
    batch, targets = _cuda_batch(fconfig, seed=20)
    _reset_launches()
    step = _step_loss_and_grads(trainer, model, batch, targets)
    step_launches = _read_launches()
    expected = _expected_launches(fconfig, view_shapes, 1, 1)
    if step_launches != expected or step_launches["msda_bwd"] != calls:
        raise AssertionError(f"{desc} step launched "
                             f"{step_launches}, expected {expected}")
    msda_layer.ms_deform_attn_core = _plain_core
    try:
        ref_step = _step_loss_and_grads(trainer, model, batch, targets)
    finally:
        msda_layer.ms_deform_attn_core = da.ms_deform_attn_core
    _compare_steps(f"{label} kernel model", "plain-core model", step,
                   ref_step)

    # Times.
    model.eval()
    with torch.inference_mode():
        fwd_ms = {B: _cuda_ms(lambda: model(batch_), reps=10, warmup=3)
                  for B, batch_ in batches.items()}
    optimizer = trainer.optimizer_factory(model.parameters())

    def train_step():
        trainer.train_step(model, batch, targets)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)

    step_ms = _cuda_ms(train_step, reps=5, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    params = sum(p.numel() for p in model.parameters())
    print(f"[{tag}] {desc}"
          f" ({params:,} parameters, built in {build_s:.1f} s): B=1 f32 "
          f"kernel vs plain core worst {max(errs):.3e} of an output's "
          f"largest element (tol {TOL[torch.float32]}), bf16 vs f32 "
          f"{bf16_err:.3e}; FLOPs per B=1 forward {flops:,} = reckoned; "
          f"forward {fwd_ms[1]:.3f} ms at B=1, {fwd_ms[4]:.3f} ms at "
          f"B=4 f32, train step B={B_TRAIN} f32 {step_ms:.3f} ms (CUDA "
          f"events); peak memory {peak:.3f} GiB; launches: forward "
          f"{fwd_launches}, step {step_launches}; "
          f"{time.perf_counter() - t0:.1f} s")
    del model, trainer, optimizer
    torch.cuda.empty_cache()
    return fwd_launches, step_launches


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


def _check_plane(what, got, want, exact_lookup=True, tol=RADAR_TOL):
    """Holds a (.., 6) plane against its reference, channel by channel,
    within ``tol``; a channel must typically be 30 times its atol.
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
        if typical[c] < 30 * tol["atol"]:
            raise AssertionError(
                f"{what}: channel {c} of the reference is typically "
                f"{typical[c]:.3e}, too small for atol {tol['atol']} "
                "to tell a wrong value from a right one")
        if not torch.allclose(got[..., c], want[..., c], **tol):
            raise AssertionError(f"{what}: channel {c} max abs err "
                                 f"{errs[c]:.3e} exceeds {tol}")
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
    from dpft_tpu_torch.utils.example import power_cube

    max_err = {"ra": 0.0, "ea": 0.0}
    for shape in RADAR_SHAPES:
        host = power_cube(shape, seed=0)
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
    from dpft_tpu_torch.utils.example import power_cube

    contiguous = torch.from_numpy(power_cube(KRADAR_CUBE, seed=0)).cuda()
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


def _host_s(fn):
    """(result, seconds) of ``fn`` on the host clock, the card drained."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_prepare(config_path, config, model, launch_paths):
    """The prepare path; returns its launches of every kernel. Then the
    export CLI on the tree that it wrote, and the flagship overfit on it
    (its launches go into ``launch_paths`` as overfit_flagship)."""
    from dpft_tpu_torch import export, prepare
    from dpft_tpu_torch.data import init as init_dataset
    from dpft_tpu_torch.data import load as load_dataset
    from dpft_tpu_torch.data import prepare as build_processor
    from dpft_tpu_torch.evaluation.evaluator import to_device
    from dpft_tpu_torch.models import registry
    from dpft_tpu_torch.ops import radar_reduce as rr
    from dpft_tpu_torch.utils.example import write_raw_kradar

    flagship = config
    root = tempfile.mkdtemp(prefix="dpft_prepare_")
    try:
        src, write_s = _host_s(lambda: write_raw_kradar(
            root, [sid for ids in FRAME_IDS.values() for sid in ids]))
        # Two large Sedans per frame, which the flagship overfit trains
        # on.
        rewrite_labels(src, two_class=False)
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

        # The export CLI on this tree (its test split gives the example
        # batch): the artifact loads and runs on the card like the model.
        # The CLIs below serve the flagship cut in depth
        # (``cut_depth_config``), to keep the script within its time.
        config = cut_depth_config(config)
        model = registry.build(config["model"]["name"], config,
                               device="cuda", seed=0).eval()
        ckpt = os.path.join(root, "run", "2026-01-01-00-00-00_checkpoint_0000.pt")
        registry.save(model, config, ckpt)
        artifact = os.path.join(root, "model.pt2")
        _reset_launches()
        _, cli_s = _host_s(lambda: export.main(dst, config_path, ckpt,
                                               artifact, batch=1))
        if any(_read_launches().values()):
            raise AssertionError(f"export.main launched {_read_launches()}")
        test_config = dict(config, train=dict(config["train"], batch_size=1))
        inputs, _ = next(iter(load_dataset(
            init_dataset(config["dataset"], src=dst, split="test",
                         config=config),
            config=test_config, shuffle=False, pad_last=True)))
        inputs = to_device(inputs, torch.device("cuda"))
        with torch.inference_mode():
            got = export.load_exported(artifact).module()(inputs)
            want = model(inputs)
        errs = []
        for key, width in (("class", 2), ("center", 3), ("size", 3),
                           ("angle", 2)):
            scale = want[key].abs().max().item()
            err = (got[key] - want[key]).abs().max().item()
            if tuple(got[key].shape) != (1, N_QUERIES, width) or \
                    not err <= TOL[torch.float32] * scale:
                raise AssertionError(f"export CLI artifact {key}: "
                                     f"{tuple(got[key].shape)}, max abs err "
                                     f"{err:.3e} of {scale}")
            errs.append(err / max(scale, 1e-30))
        print(f"[prepare] python -m dpft_tpu_torch.export --batch 1 on this "
              f"tree: {cli_s:.2f} s, no kernel launched while tracing; the "
              f"artifact ({os.path.getsize(artifact) / 2 ** 20:.1f} MiB) "
              f"loads and runs the test frame within {max(errs):.3e} of an "
              f"output's largest element of the eager forward (tol "
              f"{TOL[torch.float32]}), ok")
        phase_reference_ckpt(root, dst, config, model)
        del model
        _timed("prepare native, BEV train and evaluate", phase_tree_clis,
               root, src, dst, flagship)
        launch_paths["overfit_flagship"] = _timed(
            "overfit_flagship", phase_overfit_flagship, dst, flagship)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def phase_reference_ckpt(root, dst, config, model):
    """The reference's own checkpoint format on the card: the flagship
    model written as a full-model pickle whose classes are ``dprt.*``
    stubs (``write_reference_pickle``, with a ``torch.device``, a
    ``functools.partial``, a numpy array and ``torch.nn.functional.relu``
    beside the tensors; no class of the port in the file) loads through
    ``registry.load`` with the same state bits, and
    ``dpft_tpu_torch.evaluate.main`` and ``dpft_tpu_torch.export.main`` run
    from it on the prepared tree ``dst``: a finite mAP, and an artifact
    that loads and runs. Two pickles that would create a marker file when
    unpickled (``os.system``, ``builtins.exec``) raise and create
    nothing: the safety of ``weights_only`` with stubs, on this torch."""
    import contextlib
    import io

    from dpft_tpu_torch import evaluate, export
    from dpft_tpu_torch.data import init as init_dataset
    from dpft_tpu_torch.data import load as load_dataset
    from dpft_tpu_torch.evaluation.evaluator import to_device
    from dpft_tpu_torch.models import registry
    from dpft_tpu_torch.utils.config import save_config

    t0 = time.perf_counter()
    run = os.path.join(root, "reference_run")
    os.makedirs(run)
    cfg = os.path.join(run, "config.json")
    save_config(config, cfg)
    ckpt = os.path.join(run, "2026-08-20-12-00-00_checkpoint_0049.pt")
    names = write_reference_pickle(model, ckpt, reference_extras())
    ours = [g for g in names if g.startswith("dpft_tpu_torch")]
    if ours or "dprt.models.dpft.DPFT" not in names:
        raise AssertionError(f"the reference pickle names {names}")
    loaded, _, epoch, _ = registry.load(ckpt, device="cuda")
    want, got = model.state_dict(), loaded.state_dict()
    differ = [k for k in want if not k.endswith("num_batches_tracked")
              and not torch.equal(got[k], want[k])]
    if set(got) != set(want) or differ or epoch != 49:
        raise AssertionError(f"the reference pickle loads other tensors: "
                             f"{differ[:5]}, epoch {epoch}")
    del loaded
    load_s = time.perf_counter() - t0

    out = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        evaluate.main(dst, cfg, ckpt, os.path.join(root, "reference_eval"))
    eval_s = time.perf_counter() - t1
    results = dict(item.split("=")
                   for item in out.getvalue().strip().splitlines()[-1].split())
    if not math.isfinite(float(results["mAP"])):
        raise AssertionError(f"evaluate.main on the reference pickle: "
                             f"{results}")
    artifact = os.path.join(root, "reference.pt2")
    t1 = time.perf_counter()
    export.main(dst, cfg, ckpt, artifact, batch=1)
    export_s = time.perf_counter() - t1
    test_config = dict(config, train=dict(config["train"], batch_size=1))
    inputs, _ = next(iter(load_dataset(
        init_dataset(config["dataset"], src=dst, split="test",
                     config=config),
        config=test_config, shuffle=False, pad_last=True)))
    inputs = to_device(inputs, torch.device("cuda"))
    with torch.inference_mode():
        got = export.load_exported(artifact).module()(inputs)
        want = model(inputs)
    for key in want:
        scale = want[key].abs().max().item()
        if not (got[key] - want[key]).abs().max().item() <= \
                TOL[torch.float32] * scale:
            raise AssertionError(f"reference artifact {key} differs")

    marker = os.path.join(root, "unpickling_ran_code")
    refused = []
    for path in write_malicious_pickles(os.path.join(root, "malicious"),
                                        marker):
        try:
            registry.load(path, config, device="cuda")
        except ValueError as exc:
            refused.append(str(exc).split(": ", 1)[-1][:60])
        else:
            raise AssertionError(f"{path} loaded")
        if os.path.exists(marker):
            raise AssertionError(f"unpickling {path} ran its code")
    print(f"[reference_ckpt] the model as a reference full-model pickle "
          f"({os.path.getsize(ckpt) / 2 ** 20:.1f} MiB, globals "
          f"{len(names)}: dprt.* stubs, torch.nn, numpy, functools, no "
          f"dpft_tpu_torch) -> registry.load on cuda: the same state bits "
          f"({load_s:.2f} s); evaluate.main from it: {out.getvalue().strip()}"
          f" ({eval_s:.2f} s); export.main from it ({export_s:.2f} s): the "
          f"artifact runs the test frame within {TOL[torch.float32]} of the "
          f"eager forward; malicious pickles refused without running "
          f"(torch {torch.__version__}): {refused}; "
          f"{time.perf_counter() - t0:.1f} s")


CONFIG_ABLATIONS = (("camera_mono", "kradar_camera_mono.json"),
                    ("radar", "kradar_radar.json"),
                    ("radar_bev", "kradar_radar_bev.json"),
                    ("radar_front", "kradar_radar_front.json"))


def phase_configs():
    """The four other shipped configs (the modality ablations: the camera
    alone, both radar views, the BEV plane alone, the front plane alone;
    the fuser at ``m_views`` 1 and 2) at full width, seed 0, each held as
    ``phase_families`` holds a family (``_hold_model``): exactly ``m_views
    x i_iter`` ``msda_fwd`` launches per forward and ``msda_bwd`` launches
    per step. Returns the launches of each forward (``serve_<config>``)
    and step (``train_<config>``)."""
    paths = {}
    for label, name in CONFIG_ABLATIONS:
        with open(os.path.join(ROOT, "config", name)) as f:
            cconfig = json.load(f)
        views = len(cconfig["model"]["inputs"])
        if cconfig["model"]["fuser"]["m_views"] != views:
            raise AssertionError(f"{name}: m_views "
                                 f"{cconfig['model']['fuser']['m_views']}")
        paths[f"serve_{label}"], paths[f"train_{label}"] = _hold_model(
            "configs", label, cconfig, f"{name} ({views} view"
            f"{'s' if views > 1 else ''})")
    return paths


def phase_remat(config):
    """``computing.remat`` on the flagship: the B=4 f32 step with the
    backbones recomputed in the backward against the step without, from
    the same weights, batch and dropout seed. Held: the loss (1e-4
    relative) and every gradient (1e-3 of its largest; printed beside the
    spread of two steps without remat, cuDNN's), every BatchNorm buffer
    bit for bit (the recompute must not update the running statistics
    again) and the same kernel launches. Printed: ms per step (CUDA
    events) and peak memory with and without, at B=4 and B=16. Returns
    the step's launches with remat (``train_remat``)."""
    from dpft_tpu_torch.models import registry
    from dpft_tpu_torch.training import CentralizedTrainer
    from dpft_tpu_torch.utils.example import example_batch, example_targets

    trainer = CentralizedTrainer.from_config(config)
    batch, targets = _cuda_batch(config, seed=20)
    model = registry.build(config["model"]["name"], config, device="cuda",
                           seed=0)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    runs = []
    for remat in (False, False, True):
        model.load_state_dict(state)
        model.remat = remat
        _reset_launches()
        step = _step_loss_and_grads(trainer, model, batch, targets)
        runs.append((step, _read_launches(),
                     {k: b.clone() for k, b in model.named_buffers()}))
    (plain, launches, buffers), (again, _, _), (remat_step, remat_launches,
                                                remat_buffers) = runs
    spread = max(((again[1][k] - g).abs().max() / g.abs().max().clamp_min(
        1e-30)).item() for k, g in plain[1].items())
    _compare_steps("remat", "no remat", remat_step, plain)
    differ = [k for k, b in buffers.items()
              if not torch.equal(b, remat_buffers[k])]
    if differ:
        raise AssertionError(f"remat changed the buffers {differ[:5]}")
    if remat_launches != launches:
        raise AssertionError(f"remat launched {remat_launches}, without "
                             f"{launches}")
    print(f"[remat] the step without remat twice: worst gradient "
          f"{spread:.3e} of its max apart (cuDNN); {len(buffers)} buffers "
          f"bit-equal with and without remat; launches {launches} both ok")
    for B in (B_TRAIN, 16):
        big = (_to_cuda(example_batch(config, B=B, cam_hw=(512, 910),
                                      seed=21)),
               _to_cuda(example_targets(config, B=B, seed=21)))
        for remat in (False, True):
            model.load_state_dict(state)
            model.remat = remat
            ms, std, peak, above = _timed_steps(trainer, model, model, *big,
                                                steps=3, warmup=1)
            print(f"[remat] B={B} f32 step, remat {remat}: {ms:.3f} ms "
                  f"(std {std:.3f}, 3 steps by CUDA events after 1); peak "
                  f"memory {peak:.3f} GiB, {above:.3f} GiB above what the "
                  f"process held before")
        del big
    del model
    torch.cuda.empty_cache()
    return {"train_remat": remat_launches}


def _gather_whole(t):
    """A tensor of a model that ``parallel.distribute`` sharded (a
    DTensor) gathered whole, on its device; any other tensor as it is.
    Every rank calls it in the same order. A dim cut over more than one
    rank is gathered through the host by the list all-gather of its mesh
    dim's group (on gloo ranks, ``DTensor.full_tensor``'s functional
    all-gather ends the process with a segmentation fault, torch 2.11 on
    an H100); over one rank the local tensor is the whole."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    whole = t.to_local()
    for i, placement in enumerate(t.placements):
        world = t.device_mesh.size(i)
        if not placement.is_shard() or world == 1:
            continue
        d, n = placement.dim, t.shape[placement.dim]
        local = whole.detach().cpu()
        chunk = -(-n // world)
        local = torch.nn.functional.pad(
            local, [0, 0] * (local.dim() - d - 1) +
            [0, chunk - local.shape[d]])
        parts = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(parts, local.contiguous(),
                        group=t.device_mesh.get_group(i))
        whole = torch.cat(parts, d).narrow(d, 0, n).to(t.device)
    return whole


def _local_bytes(tensors):
    from torch.distributed.tensor import DTensor

    return sum((t.to_local() if isinstance(t, DTensor) else t).numel()
               * t.element_size() for t in tensors)


def _spawn_ranks(target, world, tmp, store):
    """Runs ``target(rank, world, tmp/store, tmp)`` in ``world`` spawned
    processes and returns their exit codes."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target,
                         args=(r, world, os.path.join(tmp, store), tmp))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [p.exitcode for p in procs]


def _tp_rank(rank, world, store, tmp):
    """One of two processes on the one card in a gloo group at the file
    ``store``, laid out by ``parallel.make_mesh`` as a (data 1, model 2)
    mesh (``init_distributed`` would give rank 1 a second card): one
    float64 B=4 flagship step on the plain core (dropout 0) of the model
    sharded by ``parallel.distribute``, its gradients gathered whole, the
    running statistics, the memory of the step (``_step_gib``), and its bytes
    of parameters and, after an AdamW step, of AdamW's moments. Writes
    ``tmp/tp<rank>.pt``."""
    import faulthandler

    import torch.distributed as dist

    from dpft_tpu_torch import parallel
    from dpft_tpu_torch.training import CentralizedTrainer
    from dpft_tpu_torch.utils.device import use_full_float32

    faulthandler.enable()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    use_full_float32()
    result = {}
    try:
        dist.init_process_group("gloo", init_method="file://" + store,
                                world_size=world, rank=rank)
        with open(os.path.join(ROOT, "config", "kradar.json")) as f:
            config = _dp_config(json.load(f))
        parallel.make_mesh(world, torch.device("cuda"))
        trainer = CentralizedTrainer.from_config(config)
        batch, targets = (_in_dtype(t, torch.float64)
                          for t in _cuda_batch(config, seed=20))
        model = _dp_model(config, torch.float64)
        parallel.distribute(model)
        result["param_bytes"] = _local_bytes(model.parameters())
        result["step_gib"] = _step_gib(
            lambda: _dp_parity_step(trainer, model, model, batch, targets),
            result["param_bytes"])
        loss, grads, stats = _dp_parity_step(trainer, model, model,
                                             batch, targets)
        optimizer = trainer.optimizer_factory(model.parameters())
        trainer.train_step(model, batch, targets)
        optimizer.step()
        result["moment_bytes"] = _local_bytes(
            v for s in optimizer.state.values() for v in s.values()
            if v.dim() > 0)
        result["float64"] = {
            "loss": loss, "stats": {k: v.cpu() for k, v in stats.items()},
            "grads": {k: v.cpu() for k, v in grads.items()}}
        if rank > 0:
            del result["float64"]["grads"], result["float64"]["stats"]
        torch.save(result, os.path.join(tmp, f"tp{rank}.pt"))
    finally:
        parallel.shutdown()


def _step_gib(step, param_bytes):
    """GiB that ``step()`` needs on the card: ``param_bytes`` (the
    parameters that it runs on) and its peak above what the process held
    before it, which leaves out what else the process holds."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step()
    return (param_bytes + torch.cuda.max_memory_allocated() - held) / 2 ** 30


def _flat(tree, prefix=""):
    """Every tensor and number of a nested state (dicts and lists), by
    its path."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def _hold_files(what, got, want, tol):
    """Two saved states (a checkpoint, an optimizer state) with the same
    paths: every float tensor within ``tol`` of its largest element, every
    other value equal. Returns the worst relative error."""
    got, want = _flat(got), _flat(want)
    if got.keys() != want.keys():
        raise AssertionError(f"{what}: other keys "
                             f"{sorted(got.keys() ^ want.keys())[:5]}")
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        if isinstance(w, torch.Tensor) and w.is_floating_point():
            if g.dtype != w.dtype or g.shape != w.shape:
                raise AssertionError(f"{what} {k}: {g.dtype} {tuple(g.shape)}"
                                     f" vs {w.dtype} {tuple(w.shape)}")
            err = ((g - w).abs().max() / w.abs().max().clamp_min(1e-300)
                   ).item() if w.numel() else 0.0
            if not err <= tol:
                raise AssertionError(f"{what} {k}: err {err:.3e} of its max "
                                     f"exceeds {tol}")
            worst = max(worst, err)
        elif not (torch.equal(g, w) if isinstance(w, torch.Tensor)
                  else g == w):
            raise AssertionError(f"{what} {k}: {g} vs {w}")
    return worst


# The trainer's float64 run in a one-rank group against the run without,
# both with SGD and momentum. Two runs without a group are bit-equal under
# deterministic algorithms, but the sharded run's arithmetic is not that
# of the run without at the last bit, and at random init the flagship step
# amplifies a rounding difference some 1e7 times (PR 10's probes: a
# relative nudge of the inputs by 1e-10 moves the float64 gradients by
# 4.4e-4 of their largest). Under AdamW that cannot be held: a gradient
# that is zero but for rounding (the attention's key bias) moves its
# parameter by the learning rate, with the sign of the rounding (1e-2 of
# in_proj_bias's largest element apart after two steps); under SGD it
# moves it by the rounding times the learning rate. A fault in the
# trainer's sharded path (a gradient not synced, a momentum lost or
# misplaced on resume) moves a tensor by the size of an update, far above
# this bound.
TP_FIT_TOL = 1e-6


def cut_depth_config(config):
    """``config`` cut in depth: every backbone a ResNet-18 and one fusion
    iteration, at the same input and level shapes. ``_tp_fit`` and the
    export_mm path run at this depth to keep the script within its
    time; what they hold (equalities of the sharded and the single-process
    fit; the program's operators, launches and outputs) holds at any
    depth."""
    config = family_config(config, "ResNet18")
    config["model"]["fuser"]["i_iter"] = 1
    return config


def _tp_fit(config, train, val, dst, resume=None):
    """``CentralizedTrainer.train`` of the float64 flagship at the depth of
    ``cut_depth_config`` on the plain core (dropout 0) from seed 0, with SGD
    and momentum (``TP_FIT_TOL``
    says why not AdamW), ``train.accumulate_steps`` 2 (the first
    micro-batch's backward does not sync, ``parallel.gradient_sync``) and
    ``train.save_optimizer``: epoch 0,
    then epoch 1 resumed in a model built anew from the epoch-0
    checkpoint and its optimizer state that the run under ``resume``
    wrote (this run's without). cuDNN and torch's other operators run
    their deterministic algorithms (the plain core's gather backward adds
    by atomics otherwise). In a process group the model is sharded over
    the group's mesh by the trainer itself. Returns per epoch the loss
    history, the checkpoint and the optimizer state that the run wrote
    (on the host)."""
    import warnings

    runs = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("once")  # a warning per operator
            for epoch in (0, 1):
                runs.append(_tp_fit_epoch(config, train, val, dst, epoch,
                                          resume or dst))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = deterministic
    return runs


def _tp_fit_epoch(config, train, val, dst, epoch, resume):
    """One run of ``_tp_fit``: epoch ``epoch``, resumed from the epoch
    before it under ``resume`` where there is one."""
    from dpft_tpu_torch.models.registry import optimizer_state_path
    from dpft_tpu_torch.training import trainer as trainer_lib

    cfg = cut_depth_config(config)
    cfg["train"].update(epochs=epoch + 1, save_optimizer=True,
                        accumulate_steps=2, optimizer={
                            "name": "SGD", "lr": 1e-4, "momentum": 0.9})
    model = _dp_model(cfg, torch.float64)
    optimizer_state = None
    if epoch:
        path = trainer_lib.checkpoint_path(resume, "ts", epoch - 1)
        model.load_state_dict(torch.load(path, map_location="cuda",
                                         weights_only=True))
        optimizer_state = trainer_lib.load_optimizer_state(path)
    result = trainer_lib.CentralizedTrainer.from_config(cfg)(
        model, train, val, start_epoch=epoch, timestamp="ts", dst=dst,
        optimizer_state=optimizer_state)
    path = trainer_lib.checkpoint_path(dst, "ts", epoch)
    return (result["history"], torch.load(path, weights_only=True),
            torch.load(optimizer_state_path(path), weights_only=True))


def phase_tensor_parallel(config, view_shapes):
    """Tensor parallelism (``computing.model_parallel``, FSDP2) on the one
    card (the train_tp path).

    (1) One NCCL rank joined through ``parallel.init_distributed``'s
    torchrun route with ``computing.model_parallel`` 1, whose mesh is (1,
    1): the flagship B=4 f32 step (dropout 0) through
    ``parallel.distribute`` equals the step without a group (loss 1e-4
    relative, gradients and running statistics 1e-3) with 12 + 12 launches;
    ms per step. Then ``CentralizedTrainer`` in that group, in float64 on
    the plain core with deterministic algorithms and SGD with momentum
    (``TP_FIT_TOL``), ``accumulate_steps`` 2, two B=2 steps and a validation
    batch with ``train.save_optimizer``, and a second epoch resumed from the
    epoch-0 checkpoint and its optimizer state that the run without a group
    wrote (both runs resume from the same files): the trainer shards the
    model, syncs the gradients, gathers the checkpoint and the optimizer
    state whole to rank 0 and lays a single process's state out over the
    shards. Every tensor of both epochs' checkpoints and optimizer states
    equals the same run without a group within ``TP_FIT_TOL`` of its largest
    element, the rest exactly, and the loss histories (computed in float32)
    within 1e-6 (relative); the spread of two runs without a group is
    printed beside it. The epoch-1 checkpoint loads in one process (the
    config's float32 model) with its tensors' bits after that cast.

    (2) Two gloo ranks sharing the card on a (1, 2) mesh: in float64 on
    the plain core their step equals the float64 step without a group
    within 1e-9 of each tensor's largest, and each rank holds half the
    parameter and moment bytes; the memory of each rank's step
    (``_step_gib``) beside the step's without a group, each after one
    step on both sides. Returns the NCCL step's launches."""
    import dpft_tpu_torch.models.layers.ms_deform_attn as msda_layer
    from dpft_tpu_torch import parallel
    from dpft_tpu_torch.models import registry
    from dpft_tpu_torch.ops import deform_attn as da
    from dpft_tpu_torch.training import CentralizedTrainer

    config = _dp_config(config)
    config["computing"]["model_parallel"] = 1
    trainer = CentralizedTrainer.from_config(config)
    batch, targets = _cuda_batch(config, seed=20)
    expected = _expected_launches(config, view_shapes, 1, 1)
    model = _dp_model(config)
    ref = _dp_parity_step(trainer, model, model, batch, targets)
    full_bytes = _local_bytes(model.parameters())
    del model
    batch64, targets64 = (_in_dtype(t, torch.float64)
                          for t in (batch, targets))
    model64 = _dp_model(config, torch.float64)
    step64 = _step_gib(lambda: _dp_parity_step(trainer, model64, model64,
                                               batch64, targets64),
                       _local_bytes(model64.parameters()))
    ref64 = _dp_parity_step(trainer, model64, model64, batch64, targets64)
    ref64 = (ref64[0], {k: v.cpu() for k, v in ref64[1].items()},
             {k: v.cpu() for k, v in ref64[2].items()})
    del model64
    # The trainer takes host batches, as a loader gives them.
    host = [{k: v.astype(np.float64) if v.dtype.kind == "f" else v
             for k, v in t.items()} for t in _host_batch(config, seed=20)]
    train = [(_rows(host[0], r, 2), _rows(host[1], r, 2)) for r in (0, 1)]
    host = [{k: v.astype(np.float64) if v.dtype.kind == "f" else v
             for k, v in t.items()} for t in _host_batch(config, seed=22)]
    val = [(_rows(host[0], 0, 2), _rows(host[1], 0, 2))]
    root = tempfile.mkdtemp(prefix="dpft_tp_")
    try:
        want = _tp_fit(config, train, val, os.path.join(root, "alone"))
        again = _tp_fit(config, train, val, os.path.join(root, "again"))
        spread = max(_hold_files(f"epoch {epoch} again", a[i], w[i], 1.0)
                     for epoch, (a, w) in enumerate(zip(again, want))
                     for i in (1, 2))
        torch.cuda.empty_cache()

        env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
               "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
               "LOCAL_WORLD_SIZE": "1"}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            parallel.init_distributed(config, "cuda")
            if parallel.model_parallel_size() != 1 or \
                    parallel.data_world_size() != 1:
                raise AssertionError("init_distributed made no (1, 1) mesh")
            model = _dp_model(config)
            net = parallel.distribute(model)
            _reset_launches()
            loss, grads, stats = _dp_parity_step(trainer, net, model, batch,
                                                 targets)
            launches = _read_launches()
            if launches != expected:
                raise AssertionError(f"the sharded step launched {launches}"
                                     f", expected {expected}")
            _compare_steps("FSDP2 (1, 1) mesh, NCCL world 1", "no group",
                           (loss, grads), ref[:2])
            _compare_stats("FSDP2 (1, 1) mesh vs no group", stats, ref[2])
            times = _timed_steps(trainer, net, model, batch, targets)
            del net, model
            torch.cuda.empty_cache()
            got = _tp_fit(config, train, val, os.path.join(root, "group"),
                          resume=os.path.join(root, "alone"))
        finally:
            parallel.shutdown()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        worst = 0.0
        for epoch, ((history, state, optim),
                    (w_history, w_state, w_optim)) in enumerate(zip(got,
                                                                     want)):
            if not np.allclose(history, w_history, rtol=1e-6, atol=0):
                raise AssertionError(f"epoch {epoch}: loss history "
                                     f"{history} vs {w_history}")
            if list(state) != list(w_state):
                raise AssertionError(f"epoch {epoch}: checkpoint keys")
            worst = max(worst, _hold_files(f"epoch {epoch} checkpoint",
                                           state, w_state, TP_FIT_TOL),
                        _hold_files(f"epoch {epoch} optimizer state", optim,
                                    w_optim, TP_FIT_TOL))
        path = os.path.join(root, "group", "ts", "checkpoints",
                            "ts_checkpoint_0001.pt")
        # A float64 file, loaded into the config's float32 model.
        loaded = registry.load(path, device="cuda")[0].state_dict()
        differ = [k for k, v in got[1][1].items()
                  if not torch.equal(loaded[k].cpu(), v.to(loaded[k].dtype))]
        if loaded.keys() != got[1][1].keys() or differ:
            raise AssertionError(f"the group's checkpoint loads other bits: "
                                 f"{differ[:5]}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[tensor_parallel] CentralizedTrainer in a one-rank NCCL group "
          f"(computing.model_parallel 1, the (1, 1) mesh of "
          f"init_distributed), the flagship cut to ResNet-18 backbones "
          f"and one fusion iteration, float64 plain core, deterministic "
          f"algorithms, SGD with momentum, accumulate_steps 2 over 2 B=2 "
          f"steps + 1 validation batch, save_optimizer, "
          f"then an epoch resumed from the epoch-0 checkpoint and its "
          f"optimizer state of the run without a group: both epochs' "
          f"checkpoints ({len(got[1][1])} tensors) and optimizer states "
          f"within {worst:.3e} of each tensor's largest of the run without a "
          f"group (tol {TP_FIT_TOL}; two runs without a group {spread:.3e} "
          f"apart), "
          f"histories {[h for h, _, _ in got]}; the "
          f"epoch-1 checkpoint loads in one process (the config's float32 "
          f"model) with the bits of its tensors cast ok")
    print(f"[tensor_parallel] B={B_TRAIN} f32 step, FSDP2 (1, 1) mesh, NCCL "
          f"world 1: {times[0]:.3f} ms (std {times[1]:.3f}, 5 steps by CUDA "
          f"events after 2); peak memory {times[2]:.3f} GiB; launches "
          f"{launches}")
    torch.cuda.empty_cache()

    world = 2
    with tempfile.TemporaryDirectory() as tmp:
        codes = _spawn_ranks(_tp_rank, world, tmp, "store")
        if codes != [0] * world:
            raise AssertionError(f"the gloo ranks exited with {codes}")
        ranks = [torch.load(os.path.join(tmp, f"tp{r}.pt"),
                            weights_only=True) for r in range(world)]
    got = ranks[0]["float64"]
    if {r["float64"]["loss"] for r in ranks} != {got["loss"]}:
        raise AssertionError("the model ranks' losses differ")
    _compare_steps(f"FSDP2 (1, {world}) mesh, {world} gloo ranks, float64",
                   "no group, float64", (got["loss"], got["grads"]),
                   ref64[:2], tol=1e-9)
    _compare_stats(f"(1, {world}) mesh vs no group, float64", got["stats"],
                   ref64[2], tol=1e-9)
    for r, result in enumerate(ranks):
        if not result["param_bytes"] * world <= full_bytes * 2 + 2 ** 20:
            raise AssertionError(f"gloo rank {r} holds "
                                 f"{result['param_bytes']} parameter bytes")
        print(f"[tensor_parallel] gloo rank {r} of the (1, {world}) mesh: "
              f"{result['param_bytes'] / 2 ** 20:.1f} MiB of float64 "
              f"parameters ({full_bytes * 2 / 2 ** 20:.1f} MiB whole), "
              f"{result['moment_bytes'] / 2 ** 20:.1f} MiB of AdamW moments;"
              f" the B={B_TRAIN} float64 step needs {result['step_gib']:.3f} "
              f"GiB, its parameters and its peak above what the rank held "
              f"before ({step64:.3f} GiB without a group)")
    msda_layer.ms_deform_attn_core = da.ms_deform_attn_core
    return {"train_tp": launches}


def phase_checkpoint_saver(config, model):
    """The flagship's checkpoint as an epoch writes it
    (``registry.CheckpointSaver``): ms that the epoch waits (the copy of
    the state_dict to the host) against ms of the whole commit in the
    background, and the file's size, by the host clock."""
    from dpft_tpu_torch.models import registry

    with tempfile.TemporaryDirectory() as tmp:
        saver = registry.CheckpointSaver()
        for epoch in range(2):
            path = os.path.join(tmp, f"ts_checkpoint_{epoch:04d}.pt")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            saver.save(model, config, path)
            waited = time.perf_counter() - t0
            saver.wait()
            whole = time.perf_counter() - t0
            state = torch.load(path, weights_only=True)
            differ = [k for k, v in model.state_dict().items()
                      if not torch.equal(state[k], v.cpu())]
            if differ or not os.path.isfile(
                    os.path.join(tmp, "config.json")):
                raise AssertionError(f"the checkpoint differs {differ[:5]}")
            print(f"[checkpoint_saver] epoch {epoch}: the epoch waits "
                  f"{1e3 * waited:.1f} ms (copy to the host), the commit "
                  f"ends after {1e3 * whole:.1f} ms; "
                  f"{os.path.getsize(path) / 2 ** 20:.1f} MiB, same bits, "
                  "config.json beside it ok")


# How far apart, in float32 ulps of the value, the two doppler bins' maxima
# of 10 log10 may lie where the host's lookup names another bin than the
# card's: each side's log10f errs by a few ulps (-Ofast's vector log10f on
# the host, CUDA's log10f on the card), and 10 x rounds once more.
TIE_ULPS = 8


def _check_native_plane(what, got, want, cube, plane):
    """``_check_plane`` for the host reduction against the card's, where
    the lookup channel (3) may differ only at ties: at each pixel where it
    does, the maxima of 10 log10 over the inner axis (elevation for "ra",
    the cropped range for "ea") in the doppler bins that ``got`` and
    ``want`` name, taken in float64 from the float32 cube (``cube()``
    gives it), lie within ``TIE_ULPS`` float32 ulps of each other. Returns
    ``_check_plane``'s numbers and the gap in ulps at each such pixel."""
    from dpft_tpu_torch.ops import radar_reduce as rr

    err, mismatches, typical, errs = _check_plane(what, got, want,
                                                  exact_lookup=False)
    gaps = []
    if mismatches:
        power = torch.as_tensor(cube(), dtype=torch.float32)
        if plane == "ra":
            inner = power.amax(2)
        else:
            lo, hi = rr._crop(power.shape[1])
            inner = power[:, lo:hi].amax(1)
        db = 10.0 * torch.log10(inner.double())
        raster = torch.as_tensor(rr._raster(power.shape[0]))
        for i, j in (got[..., 3] != want[..., 3]).nonzero().tolist():
            a, b = (db[int((raster == v[i, j, 3]).nonzero()[0, 0]), i, j]
                    .item() for v in (got, want))
            gap = abs(a - b) / float(np.spacing(np.float32(max(abs(a),
                                                               abs(b)))))
            if not gap <= TIE_ULPS:
                raise AssertionError(
                    f"{what}: the lookup at pixel {(i, j)} names another bin"
                    f" ({got[i, j, 3].item()} vs {want[i, j, 3].item()}) whose"
                    f" maxima {a!r} and {b!r} dB lie {gap:.1f} float32 ulps "
                    f"apart, more than a tie's {TIE_ULPS}")
            gaps.append(round(gap, 2))
    return err, mismatches, typical, errs, gaps


def _cpu_model():
    """The host CPU's model name (``lscpu``, else /proc/cpuinfo)."""
    for line in _run(["lscpu"]).splitlines():
        if line.startswith("Model name:"):
            return line.split(":", 1)[1].strip()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip().lower()
                if key in ("model name", "cpu model", "processor model"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    import platform
    return f"not named by lscpu or /proc/cpuinfo ({platform.machine()})"


def phase_native_radar():
    """The host SIMD reduction (``prepare_device: "native"``, csrc/
    radar_reduce_host.cc built by g++ into build/kernels) on a full
    (64, 256, 37, 107) cube against the CUDA kernels' planes, at phase
    14's tolerance, the lookup channel equal but at ties
    (``_check_native_plane``); ms per cube on the host
    (the CPU's model name beside it)."""
    from dpft_tpu_torch.ops import radar_reduce as rr
    from dpft_tpu_torch.ops.radar_reduce_native import \
        reduce_tesseract_native
    from dpft_tpu_torch.utils.example import power_cube

    cube = power_cube(KRADAR_CUBE, seed=31)
    want = [p.cpu() for p in rr.reduce_tesseract(torch.from_numpy(cube)
                                                  .cuda())]
    got, build_s = _host_s(lambda: reduce_tesseract_native(cube))
    times = []
    for _ in range(3):
        _, s = _host_s(lambda: reduce_tesseract_native(cube))
        times.append(s)
    for name, g, w in zip(("RA", "EA"), got, want):
        err, mismatches, typical, errs, gaps = _check_native_plane(
            f"native {name}", torch.from_numpy(g), w, lambda: cube,
            name.lower())
        print(f"[native_radar] {name} plane of {KRADAR_CUBE}, host SIMD vs "
              f"CUDA kernels: max abs err {err:.3e} per channel "
              f"{_channels(errs)}, typical {_channels(typical)}; "
              f"{mismatches} of {g[..., 3].size} lookups on another bin, at "
              f"ties {gaps} float32 ulps apart (at most {TIE_ULPS}) ok")
    print(f"[native_radar] host reduction of one cube: "
          f"{1e3 * min(times):.1f} / {1e3 * float(np.median(times)):.1f} ms "
          f"(best / median of 3, host clock; first call with the g++ build "
          f"{build_s:.1f} s) on {_cpu_model()}, {os.cpu_count()} cores")


def phase_tree_clis(root, src, dst, config):
    """On the raw tree and the tree that the prepare phase wrote: prepare
    with ``prepare_device: "native"`` (the same files, ``ra.npy`` /
    ``ea.npy`` as ``_check_native_plane`` holds them), then
    ``dpft_tpu_torch.train.main`` for one epoch and
    ``dpft_tpu_torch.evaluate.main`` with config/kradar_radar_bev.json (the
    BEV plane alone, full width) on the card."""
    from dpft_tpu_torch import evaluate, prepare, train
    from dpft_tpu_torch.data import prepare as build_processor

    native = json.loads(json.dumps(config))
    native["data"]["prepare_device"] = "native"
    cfg = os.path.join(root, "native.json")
    with open(cfg, "w") as f:
        json.dump(native, f)
    out = os.path.join(root, "native")
    _reset_launches()
    _, native_s = _host_s(lambda: prepare.main(src, cfg, out))
    if any(_read_launches().values()):
        raise AssertionError(f"native prepare launched {_read_launches()}")
    files = sorted(os.path.relpath(os.path.join(d, n), out)
                   for d, _, names in os.walk(out) for n in names)
    want = sorted(os.path.relpath(os.path.join(d, n), dst)
                  for d, _, names in os.walk(dst) for n in names)
    if files != want:
        raise AssertionError("native prepare wrote other files")
    processor = build_processor(config["dataset"], config)
    worst, moved, ties = 0.0, 0, []
    for name in files:
        plane = os.path.basename(name)[:2]
        if os.path.basename(name) in ("ra.npy", "ea.npy"):
            sid = os.path.basename(os.path.dirname(name))
            err, mismatches, _, _, gaps = _check_native_plane(
                f"native {name}", torch.from_numpy(np.load(os.path.join(
                    out, name))), torch.from_numpy(np.load(os.path.join(
                        dst, name))),
                lambda: processor.get_radar_tesseract(os.path.join(
                    src, SEQUENCE, "radar_tesseract",
                    f"tesseract_{sid.split('_')[0]}.mat")), plane)
            worst, moved = max(worst, err), moved + mismatches
            ties += gaps
    print(f"[prepare] prepare_device \"native\" on the raw tree: "
          f"{native_s:.2f} s, no kernel launched, the same {len(files)} "
          f"files, planes within {worst:.3e} of the card's, {moved} lookups "
          f"on another bin in all, at ties {ties} float32 ulps apart (at "
          f"most {TIE_ULPS}) ok")

    with open(os.path.join(ROOT, "config", "kradar_radar_bev.json")) as f:
        bev = json.load(f)
    bev["train"].update(epochs=1, logging="step")
    cfg = os.path.join(root, "bev.json")
    with open(cfg, "w") as f:
        json.dump(bev, f)
    log = os.path.join(root, "bev_log")
    _, train_s = _host_s(lambda: train.main(dst, cfg, log, device="cuda"))
    ckpts = [os.path.join(d, n) for d, _, names in os.walk(log)
             for n in names if n.endswith("_checkpoint_0000.pt")]
    if len(ckpts) != 1:
        raise AssertionError(f"BEV training wrote {ckpts}")
    scalars = [os.path.join(d, n) for d, _, names in os.walk(log)
               for n in names if n == "scalars.jsonl"]
    with open(scalars[0]) as f:
        steps = [row for row in map(json.loads, f)
                 if row["split"] == "train" and "step" in row]
    trained = sum(row["loss"] > 0 for row in steps)
    if not trained:
        raise AssertionError(f"BEV training: no step with a loss above 0 "
                             f"({steps})")
    _, eval_s = _host_s(lambda: evaluate.main(dst, cfg, ckpts[0],
                                              os.path.join(root, "bev_eval"),
                                              device="cuda"))
    results = [os.path.join(d, n) for d, _, names in
               os.walk(os.path.join(root, "bev_eval"))
               for n in names if n == "results.json"]
    with open(results[0]) as f:
        metrics = json.load(f)
    if not all(math.isfinite(metrics[k]) for k in ("mAP", "mGIoU")):
        raise AssertionError(f"BEV evaluation: {metrics}")
    boxes, present = _bev_test_classes(bev, dst, ckpts[0])
    if not sum(boxes.values()):
        raise AssertionError("the BEV test split has no labelled object")
    # The metric (the reference's rule) scores a sample 1.0 where fewer
    # than two classes are present among its targets and predictions.
    if metrics["mAP"] == 1.0 and any(len(p) > 1 for p in present):
        raise AssertionError(f"BEV mAP 1.0 with the classes {present} "
                             "present")
    print(f"[prepare] kradar_radar_bev.json on this tree: train.main one "
          f"epoch {train_s:.1f} s, {trained} of {len(steps)} steps with a "
          f"loss above 0; evaluate.main {eval_s:.1f} s (mAP "
          f"{metrics['mAP']}, mGIoU {metrics['mGIoU']}) on "
          f"{sum(boxes.values())} labelled objects of the classes "
          f"{dict(boxes)}; the classes present per test sample (targets and "
          f"predicted labels of the trained checkpoint) {present} ok")


def _bev_test_classes(config, src, checkpoint):
    """The test split of ``src`` through the model of ``checkpoint``: the
    count of real targets per class, and per real sample the classes
    present among its targets and its queries' predicted labels."""
    import collections

    from dpft_tpu_torch.data import init as init_dataset
    from dpft_tpu_torch.data import load as load_dataset
    from dpft_tpu_torch.evaluation.evaluator import to_device
    from dpft_tpu_torch.models import registry

    loader = load_dataset(init_dataset(config["dataset"], src=src,
                                       split="test", config=config),
                          config=config, shuffle=False, pad_last=True)
    model = registry.load(checkpoint, device="cuda")[0].eval()
    boxes, present = collections.Counter(), []
    with torch.inference_mode():
        for inputs, targets in loader:
            labels = model(to_device(inputs, torch.device("cuda")))[
                "class"].argmax(-1).cpu()
            gt = targets["gt_class"].argmax(-1)
            for b in range(len(gt)):
                if not targets["sample_mask"][b]:
                    continue
                real = gt[b][targets["gt_mask"][b]].tolist()
                boxes.update(real)
                present.append(sorted(set(real) | set(labels[b].tolist())))
    del model
    return boxes, present


# The overfit recipe of tests/test_overfit_metrics.py on the raw tree of
# tests/kradar_fixture.py (written here by ``write_fixture_tree``, without
# importing either): four frames of sequence 10 at the fixture's shapes, two
# large boxes per frame, the small model of tests/test_e2e.py, AdamW at lr
# 3e-3 for 80 epochs, loss weights {2, 1, 1, 1, 1}, no per-step metric.
FIXTURE_IDS = {"train": ("00027_00001", "00028_00002"),
               "val": ("00039_00013",), "test": ("00309_00283",)}
FIXTURE_CUBE = (8, 32, 6, 10)  # (doppler, range, elevation, azimuth)
FIXTURE_IMAGE_HW = (64, 96)  # one half of the stereo image
OVERFIT_EPOCHS = 80
# The floors of tests/test_overfit_metrics.py:109-156: matched centers within
# 2 m, angles within 0.3, heights above 1, mAP above 0.5, mGIoU above 0
# (single class) or -0.2 (two classes).
FLOOR_CENTER_M, FLOOR_ANGLE, FLOOR_HEIGHT, FLOOR_MAP = 2.0, 0.3, 1.0, 0.5
FLOOR_MGIOU = {False: 0.0, True: -0.2}
# The runs of phase_overfit: (label, two classes, "mm", seed); the port's
# own init from each seed (the card has no JAX to draw the JAX test's).
OVERFIT_RUNS = (("overfit", False, False, 0), ("overfit", False, False, 1),
                ("overfit", False, False, 2), ("overfit", False, False, 3),
                ("overfit_two_class", True, False, 0),
                ("overfit_mm", False, True, 0))
# The runs at which the same run on the CPU (plain versions, one thread,
# float32; PERF.md, the learning path) met every floor, and of those the ones
# that still met them with the initial weights nudged by 1e-6 (relative,
# two draws): the card holds the floors at these. The recipe is fragile to
# the draw in both packages (3 of seeds 0-7 each), and seed 2 met them on
# the CPU but under neither nudge, so the card's arithmetic decides it
# there: it is read (on the card its plain-core run missed them as its
# kernel run did, PERF.md, the learning path).
CPU_MET_FLOORS = {("overfit", 1), ("overfit", 2)}
CPU_MET_FLOORS_NUDGED = {("overfit", 1)}
# Epochs of the kernel run held against the plain-core run from the same
# init, and the loss tolerance (relative) per epoch. Epoch 0 runs on the
# same weights: phase 7's single-step bound. Every update after it carries
# the step's rounding through AdamW, which moves an element whose gradient
# is zero but for rounding a whole learning rate, and the recipe amplifies
# it: on the CPU, the port's and JAX's float32 runs from the same weights
# parted by 1.6e-3 after one update and 4e-3 after nine, and a 1e-10
# relative nudge of one package's float64 weights moved its loss 2.2e-2 by
# update 9; on the card the kernel and plain runs parted by up to 2.3e-2
# by epoch 9 (PERF.md, the learning path).
PLAIN_EPOCHS = 10
PLAIN_LOSS_RTOL = (1e-4,) + (1e-2,) * 2 + (1e-1,) * (PLAIN_EPOCHS - 3)
# The flagship overfit's budget: 90 s, not the 120 s first planned, so that
# the whole script stays within 900 s on the card's hosts so far (in
# 120 s its loss fell from 84 to 2.6-3.4).
FLAGSHIP_OVERFIT_S = 90.0


def fixture_config(max_boxes=8):
    """tests/kradar_fixture.py:base_config."""
    return {
        "dataset": "kradar",
        "computing": {"dtype": "float32", "seed": 0, "workers": 2,
                      "device": "cpu"},
        "data": {
            "revision": "v2", "image_size": 32, "num_classes": 2,
            "max_boxes": max_boxes,
            "categories": {
                "Sedan": 0, "Bus or Truck": -1, "Motorcycle": -1,
                "Bicycle": -1, "Bicycle Group": -1, "Pedestrian": -1,
                "Pedestrian Group": -1, "Background": -1},
            "fov": {"x": [0.0, 72.0], "y": [-6.4, 6.4], "z": [-2.0, 6.0],
                    "azimuth": [-50, 50]}},
        "train": {"batch_size": 2, "shuffle": True, "epochs": 1,
                  "logging": None,
                  "optimizer": {"name": "AdamW", "lr": 1e-4},
                  "anassigner": "HungarianAnassigner",
                  "criterion": "SetCriterion",
                  "loss_weights": {"total_class": 1.0, "object_class": 0.0,
                                   "center": 1.0, "size": 1.0, "angle": 1.0},
                  "scheduler": {"name": "ConstantLR", "factor": 1.0}},
        "evaluate": {"logging": None,
                     "metrics": {"mAP": "mAP3D", "mGIoU": "mGIoU3D"},
                     "exporter": {"name": "kradar"}}}


def overfit_config(two_class=False, mm=False, seed=0):
    """The overfit recipe's config: tests/test_e2e.py's small model on the
    fixture's config with tests/test_overfit_metrics.py's settings."""
    views = ["camera_mono", "radar_bev", "radar_front"]
    config = fixture_config()
    config["model"] = {
        "name": "dprt", "inputs": views,
        "skiplinks": {k: True for k in views},
        "backbones": {
            "camera_mono": {"name": "ResNet18", "multi_scale": 4},
            "radar_bev": {"name": "ResNet18", "in_channels": 6,
                          "multi_scale": 4},
            "radar_front": {"name": "ResNet18", "in_channels": 6,
                            "multi_scale": 4}},
        "necks": {k: {"name": "FPN", "in_channels_list":
                      [3 if k == "camera_mono" else 6, 64, 128, 256, 512],
                      "out_channels": 16} for k in views},
        "embeddings": {k: {"name": "sinusoidal_embedding", "num_feats": 16,
                           "n_levels": 5, "normalize": True} for k in views},
        "querent": {"name": "data_agnostic_static_querent",
                    "transformation": "spher2cart",
                    "resolution": [4, 4, 1],
                    "minimum": [4, -50, 0], "maximum": [72, 50, 0]},
        "fuser": {"name": "IMPFusion", "i_iter": 1, "m_views": 3,
                  "d_model": 16, "d_ffn": 32, "n_queries": 16,
                  "n_levels": [5, 5, 5], "n_heads": [8, 8, 8],
                  "n_points": [4, 4, 4], "norm": True, "dropout": 0.0,
                  "reduction": "linear", "activation": "Mish"},
        "head": {"name": "linear_detection_head", "in_channels": 16,
                 "num_classes": 2, "num_reg_layers": 2,
                 "num_cls_layers": 2}}
    config["computing"]["seed"] = seed
    config["train"]["epochs"] = OVERFIT_EPOCHS
    config["train"]["optimizer"]["lr"] = 3e-3
    config["train"]["loss_weights"] = {
        "total_class": 2.0, "object_class": 1.0,
        "center": 1.0, "size": 1.0, "angle": 1.0}
    if two_class:
        config["data"]["num_classes"] = 3
        config["model"]["head"]["num_classes"] = 3
        config["data"]["categories"]["Bus or Truck"] = 1
    if mm:
        config["model"]["fuser"]["pallas_msda"] = "mm"
    config["train"]["evaluating"] = -1
    return config


def overfit_labels(two_class):
    """tests/test_overfit_metrics.py:_write_boxes's two large boxes (the
    processor doubles l/w/h: 3 x 2 x 1 here is a 6 x 4 x 2 m box)."""
    far = ("*, 1, Bus or Truck, 45.0, -2.0, 0.2, 5.0, 4.0, 2.5, 1.5\n"
           if two_class else
           "*, 1, Sedan, 45.0, -2.0, 0.2, 5.0, 3.0, 2.0, 1.0\n")
    return "*, 0, Sedan, 20.0, 1.0, 0.5, 0.0, 3.0, 2.0, 1.0\n" + far


def rewrite_labels(src, two_class):
    """Every label file of ``src`` keeps its header line and gets the two
    boxes of ``overfit_labels``."""
    directory = os.path.join(src, SEQUENCE, "info_label_v2")
    for name in sorted(os.listdir(directory)):
        path = os.path.join(directory, name)
        with open(path) as f:
            header = f.readline()
        with open(path, "w") as f:
            f.write(header + overfit_labels(two_class))


def write_fixture_tree(root, two_class=None):
    """tests/kradar_fixture.py:make_raw_kradar's raw tree under
    ``root/raw``, the same files and bits (the same draws of
    ``np.random.default_rng(7)`` in the same order); with ``two_class`` a
    bool, its labels rewritten to the overfit recipe's two boxes. Returns
    the raw tree's path."""
    import cv2
    from scipy.io import savemat

    from dpft_tpu_torch.data.pcd import write_pcd

    rng = np.random.default_rng(7)
    src = os.path.join(root, "raw")
    base = os.path.join(src, SEQUENCE)
    for sub in ("info_label_v2", "info_calib", "cam-front",
                "radar_tesseract", "os1-128", "os2-64"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    with open(os.path.join(base, "description.txt"), "w") as f:
        f.write("urban,day,normal")
    with open(os.path.join(base, "info_calib", "calib_camera_lidar.txt"),
              "w") as f:
        f.write("header\n")
        p = [300.0, 0.0, 48.0, 0.0, 0.0, 300.0, 32.0, 0.0, 0.0, 0.0, 1.0, 0.0]
        f.write(",".join(str(v) for v in p))
    with open(os.path.join(base, "info_calib", "calib_radar_lidar.txt"),
              "w") as f:
        f.write("header\n")
        f.write("0,2.54,0.3")  # frame difference, dx, dy

    h, w = FIXTURE_IMAGE_HW
    for sid in (sid for ids in FIXTURE_IDS.values() for sid in ids):
        idx = sid.split("_")[0]
        with open(os.path.join(base, "info_label_v2", f"{sid}.txt"),
                  "w") as f:
            f.write(f"timestamp={idx}_{idx}_{idx}_{idx}_{idx}\n")
            f.write("*, 0, Sedan, 20.0, 1.0, 0.5, 10.0, 2.0, 1.0, 0.8\n")
            f.write("*, 1, Sedan, 40.0, -2.0, 0.2, -5.0, 2.2, 0.9, 0.7\n")
            f.write("*, 2, Bus or Truck, 30.0, 3.0, 0.5, 0.0, 4.0, 1.5, 1.5\n")
        stereo = rng.integers(0, 255, size=(h, 2 * w, 3), dtype=np.uint8)
        cv2.imwrite(os.path.join(base, "cam-front", f"cam-front_{idx}.png"),
                    stereo)
        tess = rng.uniform(1e8, 1e12, size=FIXTURE_CUBE).astype(np.float64)
        savemat(os.path.join(base, "radar_tesseract", f"tesseract_{idx}.mat"),
                {"arrDREA": tess})
        n_pts = 120
        fields = {
            "x": rng.uniform(0.5, 60, n_pts).astype(np.float32),
            "y": rng.uniform(-10, 10, n_pts).astype(np.float32),
            "z": rng.uniform(-2, 4, n_pts).astype(np.float32),
            "intensity": rng.uniform(0, 255, n_pts).astype(np.float32),
            "t": rng.integers(0, 1_000_000, n_pts).astype(np.uint32),
            "reflectivity": rng.integers(0, 65535, n_pts).astype(np.uint16),
            "ring": rng.integers(0, 128, n_pts).astype(np.uint8),
            "ambient": rng.integers(0, 65535, n_pts).astype(np.uint16),
            "range": rng.integers(0, 200_000, n_pts).astype(np.uint32),
        }
        fields["x"][:3] = 0.0  # missing returns
        write_pcd(os.path.join(base, "os1-128", f"os1-128_{idx}.pcd"), fields)
        write_pcd(os.path.join(base, "os2-64", f"os2-64_{idx}.pcd"),
                  dict(fields, x=fields["x"] + 0.05))
    if two_class is not None:
        rewrite_labels(src, two_class)
    return src


def floor_readings(out, targets, indices, metrics, two_class):
    """Every reading of the overfit test's floors off one forward: per
    matched query its center error, whether its class wins, its angle
    error, its height and its IoU3D with its target (``ops.iou``); mAP and
    mGIoU; and per sample the classes present among its targets and
    predicted labels, which decide whether the metric's selection engages
    (two or more) or it reads 1.0 by rule."""
    from dpft_tpu_torch.ops.boxes import decode_corners
    from dpft_tpu_torch.ops.iou import iou3d

    get = {k: v.detach().double().cpu() for k, v in out.items()}
    tgt = {k: torch.as_tensor(v).cpu() for k, v in targets.items()}
    qi, gj = (i.cpu() for i in indices)
    label = get["class"].argmax(-1)
    matched, present = [], []
    for b in range(get["center"].shape[0]):
        real = tgt["gt_mask"][b].bool()
        gt_label = tgt["gt_class"][b].argmax(-1)
        present.append(sorted(set(label[b].tolist())
                              | set(gt_label[real].tolist())))
        for k in range(int(real.sum())):
            q, g = int(qi[b, k]), int(gj[b, k])
            box = decode_corners(*(get[n][b, q][None]
                                   for n in ("center", "size", "angle")))
            gt = decode_corners(*(tgt[f"gt_{n}"][b, g][None].double()
                                  for n in ("center", "size", "angle")))
            matched.append({
                "sample": b, "query": q, "target": g,
                "center_error": float((get["center"][b, q] - tgt[
                    "gt_center"][b, g].double()).norm()),
                "class_ok": bool(label[b, q] == gt_label[g]),
                "class": int(gt_label[g]),
                "angle_error": float((get["angle"][b, q] - tgt[
                    "gt_angle"][b, g].double()).abs().max()),
                "height": float(get["size"][b, q, 2]),
                "iou3d": float(iou3d(box, gt).reshape(-1)[0])})
    return {"matched": matched, "present": present,
            "mAP": float(metrics["mAP"]), "mGIoU": float(metrics["mGIoU"]),
            "two_class": two_class}


def floor_failures(readings, history):
    """The overfit test's floors that ``readings`` and the loss
    ``history`` miss, and samples with fewer than two classes present
    (empty when all hold)."""
    missed = []
    if not all(map(math.isfinite, history)):
        missed.append(("finite loss", history))
    elif not history[-1] < 0.5 * history[0]:
        missed.append(("loss halves", history[0], history[-1]))
    for m in readings["matched"]:
        for name, ok in (("center", m["center_error"] < FLOOR_CENTER_M),
                         ("class", m["class_ok"]),
                         ("angle", m["angle_error"] < FLOOR_ANGLE),
                         ("height", m["height"] > FLOOR_HEIGHT)):
            if not ok:
                missed.append((name, m))
    if readings["two_class"] and \
            {m["class"] for m in readings["matched"]} != {1, 2}:
        missed.append(("matched classes", readings["matched"]))
    for b, classes in enumerate(readings["present"]):
        if len(classes) < 2:
            missed.append(("two classes present", b, classes))
    if not readings["mAP"] > FLOOR_MAP:
        missed.append(("mAP", readings["mAP"]))
    if not readings["mGIoU"] > FLOOR_MGIOU[readings["two_class"]]:
        missed.append(("mGIoU", readings["mGIoU"]))
    return missed


def floor_report(history, readings):
    """One line: the loss's ends, per matched query its center error (m)
    and IoU3D, mAP, mGIoU and the classes present per sample."""
    return (f"loss {history[0]:.4f} -> {history[-1]:.4f}; centers/IoU3D "
            + ", ".join(f"{m['center_error']:.3f}/{m['iou3d']:.3f}"
                        for m in readings["matched"])
            + f"; mAP {readings['mAP']:.4f} mGIoU {readings['mGIoU']:.4f}; "
            f"present {readings['present']}")


def _train_loaders(config, processed):
    """The train split's shuffled loader and its first batch unshuffled,
    as tests/test_overfit_metrics.py reads them."""
    from dpft_tpu_torch.data import init as init_dataset
    from dpft_tpu_torch.data import load as load_dataset

    dataset = init_dataset(config["dataset"], src=processed, split="train",
                           config=config)
    first = next(iter(load_dataset(dataset, config=config, shuffle=False)))
    return load_dataset(dataset, config=config), first


def _prepare_fixture(root, two_class, cfg):
    """The fixture's raw tree with the recipe's boxes, prepared on the card
    by ``prepare.main``; holds its planes against the plain version and
    returns the processed tree, the launches and the worst plane error."""
    from dpft_tpu_torch import prepare
    from dpft_tpu_torch.data import prepare as build_processor
    from dpft_tpu_torch.ops import radar_reduce as rr

    src = write_fixture_tree(root, two_class)
    dst = os.path.join(root, "processed")
    _reset_launches()
    prepare.main(src, cfg, dst)
    launches = _read_launches()
    with open(cfg) as f:
        config = json.load(f)
    processor = build_processor(config["dataset"], config)
    worst = 0.0
    for split, ids in FIXTURE_IDS.items():
        for sid in ids:
            cube = torch.from_numpy(processor.get_radar_tesseract(
                os.path.join(src, SEQUENCE, "radar_tesseract",
                             f"tesseract_{sid.split('_')[0]}.mat"))).cuda()
            for name, want in zip(("ra", "ea"),
                                  rr.reduce_tesseract_plain(cube)):
                got = torch.from_numpy(np.load(os.path.join(
                    dst, split, SEQUENCE, sid, f"{name}.npy"))).cuda()
                worst = max(worst, _check_plane(
                    f"fixture {sid}/{name}.npy", got, want,
                    tol=FIXTURE_RADAR_TOL)[0])
    return dst, launches, worst


def _plain_history(config, processed, seed, epochs):
    """The loss history of the first ``epochs`` epochs from the same init
    on the plain MSDA core."""
    import dpft_tpu_torch.models.layers.ms_deform_attn as msda_layer
    from dpft_tpu_torch.ops import deform_attn as da

    config = dict(config, train=dict(config["train"], epochs=epochs))
    msda_layer.ms_deform_attn_core = _plain_core
    try:
        return _overfit_run(config, processed, seed, kernels=False)[1]
    finally:
        msda_layer.ms_deform_attn_core = da.ms_deform_attn_core


def _overfit_run(config, processed, seed, kernels=True):
    """The recipe's epochs from the port's own init at ``seed`` (no
    checkpoint): the model, its loss history, its launches, seconds and
    floor readings on the first train batch. With ``kernels`` the launches
    must be the model's for every step (on the plain core: none)."""
    from dpft_tpu_torch.evaluation.evaluator import to_device
    from dpft_tpu_torch.evaluation.metric import build_metric
    from dpft_tpu_torch.models import registry
    from dpft_tpu_torch.training import CentralizedTrainer

    model = registry.build("dprt", config, device="cuda", seed=seed)
    loader, (batch, targets) = _train_loaders(config, processed)
    trainer = CentralizedTrainer.from_config(config)
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    history = trainer.train(model, loader, dst=None)["history"]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read_launches()
    batch = to_device(batch, torch.device("cuda"))
    targets = to_device(targets, torch.device("cuda"))
    with torch.inference_mode():
        out = model(batch)
        views = model.features(batch)
    readings = floor_readings(
        out, targets, trainer.loss_fn.match(out, targets),
        build_metric(config["evaluate"])(out, targets),
        config["data"]["num_classes"] == 3)
    shapes = dict(zip(model.inputs, (s for _, s in views)))
    steps = len(history) * len(loader)
    expected = (_expected_launches(config, shapes, steps, steps) if kernels
                else dict.fromkeys(KERNELS, 0))
    if launches != expected:
        raise AssertionError(f"{len(history)} epochs launched {launches}, "
                             f"expected {expected}")
    return model, history, launches, seconds, readings


def _evaluate_and_export(root, processed, config, model, label):
    """``evaluate.main`` and ``export.main`` on the run's one checkpoint:
    a finite mAP in ``results.json``; the artifact gives the eager outputs
    on the test frame within float32's tolerance."""
    from dpft_tpu_torch import evaluate, export
    from dpft_tpu_torch.data import init as init_dataset
    from dpft_tpu_torch.data import load as load_dataset
    from dpft_tpu_torch.evaluation.evaluator import to_device
    from dpft_tpu_torch.models import registry

    config = dict(config, train=dict(config["train"], logging="epoch"))
    cfg = os.path.join(root, f"{label}.json")
    with open(cfg, "w") as f:
        json.dump(config, f)
    ckpt = os.path.join(root, label, "checkpoints",
                        f"{label}_checkpoint_{OVERFIT_EPOCHS - 1:04d}.pt")
    registry.save(model, config, ckpt)
    written = [n for _, _, names in os.walk(os.path.join(root, label))
               for n in names if n.endswith(".pt")]
    if len(written) != 1:
        raise AssertionError(f"{label} wrote checkpoints {written}")
    print(f"[overfit] {label}: its one checkpoint, {os.path.getsize(ckpt):,} "
          "bytes")
    evaluate.main(processed, cfg, ckpt, os.path.join(root, "eval"))
    with open(os.path.join(root, "eval", label, "results.json")) as f:
        results = json.load(f)
    if not all(math.isfinite(results[k]) for k in ("mAP", "mGIoU")):
        raise AssertionError(f"{label} evaluate.main: {results}")
    artifact = os.path.join(root, f"{label}.pt2")
    export.main(processed, cfg, ckpt, artifact, batch=1)
    test = dict(config, train=dict(config["train"], batch_size=1))
    inputs, _ = next(iter(load_dataset(
        init_dataset(config["dataset"], src=processed, split="test",
                     config=config), config=test, shuffle=False,
        pad_last=True)))
    inputs = to_device(inputs, torch.device("cuda"))
    with torch.inference_mode():
        got = export.load_exported(artifact).module()(inputs)
        want = model(inputs)
    worst = 0.0
    for key in ("class", "center", "size", "angle"):
        scale = want[key].abs().max().item()
        err = (got[key] - want[key]).abs().max().item()
        if not err <= TOL[torch.float32] * scale:
            raise AssertionError(f"{label} artifact {key}: err {err:.3e} "
                                 f"of {scale}")
        worst = max(worst, err / max(scale, 1e-30))
    return results, worst


def phase_overfit():
    """The learning path at the small config (``OVERFIT_RUNS``): the
    fixture's raw tree prepared on the card (the radar kernels at 6
    elevation bins, planes held against the plain version), 80 epochs of
    tests/test_overfit_metrics.py's recipe through the trainer with the
    hand kernels per run, each kernel run's first ``PLAIN_EPOCHS`` losses
    held against a plain-core run from the same init, the floors held at
    ``CPU_MET_FLOORS_NUDGED`` and read elsewhere, and ``evaluate.main`` and
    ``export.main`` on a run's one checkpoint. Returns the launches of
    the paths overfit_prepare, overfit and overfit_mm."""
    root = tempfile.mkdtemp(prefix="dpft_overfit_")
    paths = {"overfit_prepare": dict.fromkeys(KERNELS, 0),
             "overfit": dict.fromkeys(KERNELS, 0),
             "overfit_mm": dict.fromkeys(KERNELS, 0)}
    try:
        trees = {}
        for two_class in (False, True):
            tree = os.path.join(root, f"tree_{int(two_class)}")
            cfg = os.path.join(root, f"prepare_{int(two_class)}.json")
            with open(cfg, "w") as f:
                json.dump(overfit_config(two_class), f)
            t0 = time.perf_counter()
            trees[two_class], launches, worst = _prepare_fixture(
                tree, two_class, cfg)
            n = sum(map(len, FIXTURE_IDS.values()))
            want = dict.fromkeys(KERNELS, 0)
            want.update(radar_reduce_ra=n, radar_reduce_ea=n)
            if launches != want:
                raise AssertionError(f"fixture prepare launched {launches}, "
                                     f"expected {want}")
            for k, v in launches.items():
                paths["overfit_prepare"][k] += v
            print(f"[overfit] prepare.main on cuda, fixture tree "
                  f"({'two classes' if two_class else 'one class'}): {n} "
                  f"cubes {FIXTURE_CUBE} in {time.perf_counter() - t0:.2f} "
                  f"s; ra/ea vs plain max_abs_err {worst:.3e} "
                  f"({FIXTURE_RADAR_TOL}, lookup exact); launches "
                  f"{launches}")

        held, read = [], []
        for label, two_class, mm, seed in OVERFIT_RUNS:
            config = overfit_config(two_class, mm, seed)
            model, history, launches, seconds, readings = _overfit_run(
                config, trees[two_class], seed)
            path = "overfit_mm" if mm else "overfit"
            for k, v in launches.items():
                paths[path][k] += v
            cpu_met = (label, seed) in CPU_MET_FLOORS
            plain = _plain_history(config, trees[two_class], seed,
                                   PLAIN_EPOCHS)
            errs = [abs(a - b) / abs(b) for a, b in zip(history, plain)]
            if len(errs) != PLAIN_EPOCHS or not all(
                    e <= tol for e, tol in zip(errs, PLAIN_LOSS_RTOL)):
                raise AssertionError(
                    f"{label} seed {seed}: kernel losses {history[:10]} vs "
                    f"plain {plain[:10]}: relative errs {errs}, tolerances "
                    f"{PLAIN_LOSS_RTOL}")
            missed = floor_failures(readings, history)
            gated = (label, seed) in CPU_MET_FLOORS_NUDGED
            (held if gated else read).append((label, seed, not missed))
            print(f"[overfit] {label} seed {seed}: {len(history)} epochs in "
                  f"{seconds:.1f} s; {floor_report(history, readings)}; "
                  f"floors {'met' if not missed else 'missed'} ("
                  + ("held: the CPU run met them, nudged too" if gated else
                     "read: the CPU run met them, not nudged" if cpu_met
                     else "read") + ");"
                  f" loss vs plain core over {PLAIN_EPOCHS} epochs: "
                  f"relative errs {[float(f'{e:.2e}') for e in errs]}; "
                  f"launches {launches}")
            if missed:
                print(f"[overfit]   missed: {[m[0] for m in missed]}")
            if gated and missed:
                raise AssertionError(f"{label} seed {seed} missed {missed}")
            if gated and not any(r[0] == label for r in held[:-1]):
                results, err = _evaluate_and_export(
                    root, trees[two_class], config, model, label)
                print(f"[overfit] {label} seed {seed}: its one checkpoint "
                      f"through evaluate.main: mAP {results['mAP']:.4f} "
                      f"mGIoU {results['mGIoU']:.4f}; export.main's "
                      f"artifact within {err:.3e} of the eager outputs")
            del model
        print(f"[overfit] floors held at {held}; read at {read}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return paths


def phase_overfit_flagship(dst, config):
    """config/kradar.json at full width on the prepare phase's K-Radar-shape
    tree ``dst``, whose labels are the recipe's two large boxes per frame:
    the trainer from seed 0 for as many epochs as ``FLAGSHIP_OVERFIT_S``
    allows, no checkpoint. Held: finite losses, the last epoch below half
    the first, exact launches. Read: the floor readings on the first train
    batch. Returns the launches of the training."""
    from dpft_tpu_torch.evaluation.evaluator import to_device
    from dpft_tpu_torch.evaluation.metric import build_metric
    from dpft_tpu_torch.models import registry
    from dpft_tpu_torch.training import CentralizedTrainer

    model = registry.build("dprt", config, device="cuda", seed=0)
    loader, (batch, targets) = _train_loaders(config, dst)

    class Budget:
        """The loader until the budget is spent, then empty epochs."""

        def __init__(self):
            self.deadline = None

        def __len__(self):
            return len(loader)

        def __iter__(self):
            self.deadline = self.deadline or (time.perf_counter()
                                              + FLAGSHIP_OVERFIT_S)
            if time.perf_counter() < self.deadline:
                yield from loader

    # Epochs after the budget are empty and cost the trainer a millisecond
    # each: an epoch of 2 steps takes about a second, so 1,000 is
    # more than the budget holds.
    trainer = CentralizedTrainer.from_config(
        dict(config, train=dict(config["train"], epochs=1000)))
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    history = trainer.train(model, Budget(), dst=None)["history"]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _read_launches()
    batch = to_device(batch, torch.device("cuda"))
    targets = to_device(targets, torch.device("cuda"))
    with torch.inference_mode():
        out = model(batch)
        views = model.features(batch)
    shapes = dict(zip(model.inputs, (s for _, s in views)))
    steps = len(history) * len(loader)
    expected = _expected_launches(config, shapes, steps, steps)
    if launches != expected:
        raise AssertionError(f"the flagship overfit launched {launches}, "
                             f"expected {expected}")
    if not (all(map(math.isfinite, history))
            and history[-1] < 0.5 * history[0]):
        raise AssertionError(f"flagship overfit losses {history[0]} -> "
                             f"{history[-1]} over {len(history)} epochs")
    readings = floor_readings(out, targets,
                              trainer.loss_fn.match(out, targets),
                              build_metric(config["evaluate"])(out, targets),
                              False)
    missed = floor_failures(readings, history)
    print(f"[overfit_flagship] config/kradar.json on the K-Radar-shape tree "
          f"({len(FRAME_IDS['train'])} train frames, two boxes each): "
          f"{len(history)} epochs x "
          f"{len(loader)} steps of B={config['train']['batch_size']} in "
          f"{seconds:.1f} s; losses {[round(x, 3) for x in history[:3]]} ... "
          f"{[round(x, 3) for x in history[-3:]]}; read, not held: "
          f"{floor_report(history, readings)}; floors of the small recipe "
          f"missed: {sorted({m[0] for m in missed})}; launches {launches}")
    del model
    return launches


# The port's bench line against the root bench.py's, mode by mode: these
# keys go, ``mfu`` and ``peak_tflops`` take the place of
# ``mfu_vs_bf16_peak``, and the card and its activity come in.
BENCH_DROPPED = {"readback_rtt_ms", "hbm_static_gb", "hbm_static",
                 "mfu_vs_bf16_peak"}
BENCH_ADDED = {"device", "power_limit_w", "launches_per_call",
               "device_busy_share", "device_ms_per_call"}
# phase_bench's runs of ``python -m dpft_tpu_torch.bench`` (label, env), and
# the cell of ``bench_scaling`` that is its inference run at B=1 in float32.
BENCH_RUNS = (
    ("inference B=4 bf16 (the default)", {}),
    ("train B=4 f32", {"BENCH_MODE": "train", "BENCH_DTYPE": "float32",
                       "BENCH_FLOPS": "1"}),
    ("prepare", {"BENCH_MODE": "prepare", "BENCH_PREPARE_BASELINE": "0"}))
BENCH_SCALING_CELL = ("inference", "1:f32")


def jax_bench_keys(mode):
    """The keys of the root bench.py's last line in ``mode``, read from its
    source with ``ast`` (it imports JAX): the dict literals returned or
    assigned to ``result`` in ``bench_<mode>`` and the keys assigned to
    ``result[...]``."""
    import ast

    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    fn = next(node for node in tree.body if isinstance(node, ast.FunctionDef)
              and node.name == f"bench_{mode}")
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
            keys |= {t.slice.value for t in node.targets
                     if isinstance(t, ast.Subscript)
                     and isinstance(t.value, ast.Name)
                     and t.value.id == "result"
                     and isinstance(t.slice, ast.Constant)}
            if "result" not in names:
                continue
        elif not isinstance(node, ast.Return):
            continue
        if isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys
                     if isinstance(k, ast.Constant)}
    return keys


def port_bench_keys(mode):
    """The keys the port's bench prints in ``mode``."""
    jax = jax_bench_keys(mode)
    keys = (jax - BENCH_DROPPED) | BENCH_ADDED
    if "mfu_vs_bf16_peak" in jax:
        keys |= {"mfu", "peak_tflops"}
    return keys


def _bench_process(args, env, timeout=600):
    """(returncode, last stdout line parsed (None if it is no JSON), the
    ``bench:`` line of stderr parsed (None if none), seconds) of a fresh
    process from the repository's root."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *args], cwd=ROOT,
                          env=dict(os.environ, **env), capture_output=True,
                          text=True, timeout=timeout)
    seconds = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    try:
        last = json.loads(lines[-1])
    except (IndexError, ValueError):
        last = None
    diag = [json.loads(line[len("bench: "):])
            for line in proc.stderr.splitlines() if line.startswith("bench: ")]
    if proc.returncode and last is None:
        print(proc.stderr[-3000:], file=sys.stderr)
    return proc.returncode, last, (diag or [None])[-1], seconds


def _check_bench_run(label, mode, run, card, limit_w, flops):
    """Holds one bench run, ``run`` = (returncode, last line, ``bench:``
    line, seconds), to ``phase_bench``'s checks; returns its last line."""
    from dpft_tpu_torch.bench import PREPARE_FRAMES

    rc, result, diag, seconds = run
    if rc != 0 or result is None or diag is None:
        raise AssertionError(f"bench {label}: exit {rc}, last line {result}")
    keys = port_bench_keys(mode)
    if set(result) != keys:
        raise AssertionError(f"bench {label}: keys {sorted(result)}; "
                             f"expected {sorted(keys)}")
    if result["device"] != card or result["power_limit_w"] != limit_w:
        raise AssertionError(f"bench {label}: device {result['device']!r} "
                             f"at {result['power_limit_w']} W, the card is "
                             f"{card!r} at {limit_w} W")
    kernels = {"inference": {"msda_fwd"}, "train": {"msda_fwd", "msda_bwd"},
               "prepare": {"radar_reduce_ra", "radar_reduce_ea"}}[mode]
    launched = {k for k, n in diag["kernel_launches"].items() if n}
    if launched != kernels or any(diag["tf32"].values()):
        raise AssertionError(f"bench {label}: {diag}")
    note = ""
    if mode == "inference" and \
            result["forward_flops"] != flops * result["batch"]:
        raise AssertionError(f"bench {label}: forward_flops "
                             f"{result['forward_flops']}, the serve path's "
                             f"{flops} x {result['batch']}")
    if mode == "train":
        ratio = result["grad_step_flops"] / (flops * result["batch"])
        if not 2 <= ratio <= 4:
            raise AssertionError(f"bench {label}: grad_step_flops "
                                 f"{result['grad_step_flops']}, {ratio} "
                                 "times the forward's")
        note = f"; grad_step_flops / forward_flops = {ratio:.4f}"
    if mode == "prepare" and result["frames"] != len(PREPARE_FRAMES):
        raise AssertionError(f"bench {label}: {result['frames']} frames of "
                             f"{len(PREPARE_FRAMES)}")
    print(f"[bench] {label}: exit 0 in {seconds:.1f} s; kernel launches "
          f"{diag['kernel_launches']}; TF32 off{note}")
    print(f"[bench]   {json.dumps(result)}")
    return result


def phase_bench(flops):
    """``python -m dpft_tpu_torch.bench`` through its real entry, in fresh
    processes that run at once with one repetition after one warm-up
    (``BENCH_RUNS``, ``BENCH_SCALING_CELL`` through ``python -m
    dpft_tpu_torch.bench_scaling``, and ``BENCH_HOIST=1``). Each run must
    exit 0 with a last line of exactly the port's keys for its mode
    (``port_bench_keys``) naming this card and its power limit; the
    inference FLOPs must be ``flops`` (the serve path's count per B=1
    forward) times B, the train step's between 2 and 4 times the forward's
    at its B; prepare must report every frame of its tree; TF32 must be off
    at the end of every run; the kernels launched (the ``bench:`` line of
    stderr) must be those of the mode. ``BENCH_HOIST=1`` must exit 1 with
    an error line. Returns every run's last line by label."""
    from concurrent.futures import ThreadPoolExecutor

    card = torch.cuda.get_device_name(0)
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    limit_w = float(smi.rsplit(",", 1)[1].split()[0])
    base = {"BENCH_REPS": "1", "BENCH_WARMUP": "1"}
    module = ("-m", "dpft_tpu_torch.bench")
    mode, cell = BENCH_SCALING_CELL
    scaling = f"bench_scaling {mode} {cell}"
    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(len(BENCH_RUNS) + 2) as pool:
        out = os.path.join(tmp, "scaling.jsonl")
        runs = {label: pool.submit(_bench_process, module, {**base, **env})
                for label, env in BENCH_RUNS}
        runs[scaling] = pool.submit(
            _bench_process,
            ("-m", "dpft_tpu_torch.bench_scaling", out, mode, cell), base)
        hoist = pool.submit(_bench_process, module, {"BENCH_HOIST": "1"})
        runs = {label: run.result() for label, run in runs.items()}
        with open(out) as f:
            rows = [json.loads(line) for line in f]

    results = {}
    for label, env in BENCH_RUNS:
        results[label] = _check_bench_run(
            label, env.get("BENCH_MODE", "inference"), runs[label], card,
            limit_w, flops)
    rc, _, diag, seconds = runs[scaling]
    if len(rows) != 1 or "error" in rows[0]:
        raise AssertionError(f"{scaling}: exit {rc}, {rows}")
    row = {k: v for k, v in rows[0].items() if k not in ("mode", "wall_sec")}
    results[scaling] = _check_bench_run(scaling, mode,
                                        (rc, row, diag, seconds), card,
                                        limit_w, flops)

    rc, result, _, seconds = hoist.result()
    if rc != 1 or "BENCH_HOIST" not in (result or {}).get("error", ""):
        raise AssertionError(f"BENCH_HOIST=1: exit {rc}, {result}")
    print(f"[bench] BENCH_HOIST=1: exit 1 in {seconds:.1f} s, {result}")
    return results


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


def _timed(phase, fn, *args, **kwargs):
    """Runs one phase and prints its seconds."""
    t0 = time.perf_counter()
    result = fn(*args, **kwargs)
    print(f"[seconds] {phase}: {time.perf_counter() - t0:.1f} s")
    return result


def main():
    start = time.perf_counter()
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

    fwd_report = _timed("kernel_vs_plain", phase_kernel_vs_plain,
                        view_shapes)
    _timed("flagship", phase_flagship, config, model)
    _timed("graphs", phase_graphs, config, model)
    paths = {}
    paths["serve"], flops = _timed("serve", phase_serve, config, model,
                                   view_shapes)
    _assert_full_float32("the serve phase")
    from dpft_tpu_torch.models import registry
    paths["export"] = _timed("export", phase_export, config, model,
                             view_shapes)
    bwd_report = _timed("bwd_vs_plain", phase_bwd_vs_plain, view_shapes)
    _timed("train_step_vs_plain", phase_train_step_vs_plain, config, model)
    _timed("step_backward_twice", phase_step_backward_twice, config, model)
    # On the initial weights, as the step above: the train phases leave
    # weights on which one step's gradients are ill-conditioned.
    mm_config, mm_model = _timed("mm_model", phase_mm_model, config, model)
    paths["train"] = _timed("train", phase_train, config, model,
                            view_shapes)
    _assert_full_float32("the train phase")
    _timed("train_timing", phase_train_timing, config, model)
    paths.update(_timed("data_parallel", phase_data_parallel, config,
                        view_shapes))
    paths.update(_timed("tensor_parallel", phase_tensor_parallel, config,
                        view_shapes))
    paths.update(_timed("remat", phase_remat, config))
    _timed("checkpoint_saver", phase_checkpoint_saver, config, model)

    mm_fwd_report, mm_bwd_report = _timed("mm_vs_plain", phase_mm_vs_plain,
                                          view_shapes)
    _timed("core_calls", phase_core_calls, view_shapes)
    paths["serve_mm"], mm_flops = _timed("serve_mm", phase_serve, mm_config,
                                         mm_model, view_shapes,
                                         label="serve_mm")
    if mm_flops != flops:
        raise AssertionError(f"FLOPS {mm_flops} under \"mm\", {flops} under "
                             "the default backend")
    print(f"[serve_mm] FLOPS under \"mm\" = the default's, {flops:,}, ok")
    export_config = cut_depth_config(mm_config)
    export_model = registry.build(export_config["model"]["name"],
                                  export_config, device="cuda", seed=0)
    paths["export_mm"] = _timed("export_mm", phase_export, export_config,
                                export_model, view_shapes, label="export_mm",
                                dtypes=("float32",))
    del export_model
    paths["train_mm"] = _timed("train_mm", phase_train, mm_config, mm_model,
                               view_shapes, label="train_mm", epochs=1,
                               n_train=2, n_val=1, resume=False)
    _timed("forwards_mm", _time_forwards, mm_config, mm_model,
           "flagship_mm")
    _timed("train_timing_mm", phase_train_timing, mm_config, mm_model,
           label="train_mm")
    _timed("trained_steps", phase_trained_steps, config, model, mm_model)
    ra_report, ea_report = _timed("radar_vs_plain", phase_radar_vs_plain)
    _timed("launch_counts", phase_launch_counts, config,
           {"default": model, "mm": mm_model})
    _timed("kernel_times", phase_kernel_times, view_shapes)
    library = _timed("msda_call_times", phase_msda_call_times, view_shapes)
    # The kernels' own times are of the camera view at B=1 (forward) and
    # B=4 (backward); so are their library times.
    fwd_report["library_ms"] = library["fwd", "camera_mono", B1]
    bwd_report["library_ms"] = library["bwd", "camera_mono", B_TRAIN]
    _timed("radar_kernel_times", phase_radar_kernel_times)
    wa_report = _timed("window_attn", phase_window_attn)
    del mm_model
    torch.cuda.empty_cache()
    paths.update(_timed("families", phase_families, config))
    paths.update(_timed("configs", phase_configs))
    _timed("native_radar", phase_native_radar)
    paths.update(_timed("overfit", phase_overfit))
    paths["prepare"] = _timed("prepare and reference_ckpt", phase_prepare,
                              config_path, config, model, paths)
    _timed("bench", phase_bench, flops)
    # `launches` is the count on the kernel's own main path.
    reports = [(fwd_report, "train"), (bwd_report, "train"),
               (mm_fwd_report, "train_mm"), (mm_bwd_report, "train_mm"),
               (ra_report, "prepare"), (ea_report, "prepare"),
               (wa_report, "serve_swin")]
    for report, own_path in reports:
        name = report["name"]
        report["launches"] = paths[own_path][name]
        report["launches_by_path"] = {path: launches[name]
                                      for path, launches in paths.items()}
    print(f"[seconds] chip_smoke.py: {time.perf_counter() - start:.1f} s")
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    print(smi.splitlines()[0] if smi else smi)
    print(json.dumps({"kernels": [report for report, _ in reports]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
