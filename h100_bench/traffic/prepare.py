"""Prepare traffic: whole calls of the program's dataset preparation.

Parameters (the mix's ``.json``): ``frames``, the frame ids of sequence
10 that the raw tree holds (in the frozen split tables, which assign each
to its split); ``distinct`` frames whose sensor files are written (every
other id links to one of them); ``cube`` the (doppler, range, elevation,
azimuth) shape of a tesseract and ``image_hw`` each half of the stereo
frame; ``warmup_frames`` the ids of a small tree that set-up prepares
once; ``sample`` prepared frames the check compares.

A call is what ``python -m dpft_tpu_torch.prepare`` runs: the processor
of the configuration (``computing.workers`` threads per sequence and
split, ``prepare_device`` default: the radar reduction on the card) over
the whole tree, into a fresh destination under ``$TMPDIR``. The window
runs whole calls; ``prepare_frames_per_s`` is the frames written over the
window's full time, the call in flight included.
"""

from __future__ import annotations

import copy
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from harness import program, raw_tree
from harness.reading import Reading
from harness.trace import traced

FILES = ("labels.npy", "description.npy", "mono.jpg", "mono_info.npy",
         "stereo.jpg", "stereo_info.npy", "ra.npy", "ra_info.npy", "ea.npy",
         "ea_info.npy", "os1.npy", "os2.npy")


class HostSeconds:
    """Host seconds spent inside wrapped methods, summed over threads."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self._lock = threading.Lock()

    def wrap(self, obj, name: str) -> None:
        inner = getattr(obj, name)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                with self._lock:
                    self.seconds[name] = (self.seconds.get(name, 0.0)
                                          + time.perf_counter() - t0)

        setattr(obj, name, timed)


class Driver:
    """Prepare cells: ``prepare_frames_per_s`` and, traced, the prepare
    readings."""

    def __init__(self, config: dict, input_shapes, traffic: dict, seed: int,
                 device: torch.device):
        self.config = copy.deepcopy(config)
        self.config["computing"]["device"] = str(device)
        self.traffic, self.seed, self.device = traffic, seed, device
        self.frames: List[str] = list(traffic["frames"])
        self.attempted = self.failed = 0
        self.outputs: List[str] = []
        self.host = HostSeconds()

    def setup(self) -> None:
        from dpft_tpu_torch.data import prepare

        clock = program.PhaseClock()
        program.full_float32()
        self.work = tempfile.mkdtemp(prefix="h100_bench_prepare_")
        self.tree = raw_tree.write(
            os.path.join(self.work, "tree"), self.frames,
            self.traffic["cube"], tuple(self.traffic["image_hw"]),
            int(self.traffic["distinct"]), self.seed)
        warm = raw_tree.RawTree(os.path.join(self.work, "warm", "raw"),
                                list(self.traffic["warmup_frames"]),
                                self.tree.sources, self.tree.image_hw)
        raw_tree.link(warm, os.path.join(self.work, "tree", "distinct"))
        clock.mark("raw_tree")
        self.processor = prepare(self.config["dataset"], self.config)
        self.host.wrap(self.processor, "get_radar_tesseract")
        self.host.wrap(self.processor, "prepare_sample")
        self.processor.prepare(warm.root, os.path.join(self.work, "warm_out"))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        shutil.rmtree(os.path.join(self.work, "warm"))
        clock.mark("warmup")
        self.phases = clock.phases

    def call(self) -> int:
        dst = os.path.join(self.work, f"out{len(self.outputs)}")
        self.attempted += len(self.frames)
        self.processor.prepare(self.tree.root, dst)
        self.outputs.append(dst)
        return len(self.frames)

    def run_window(self, seconds: float) -> Tuple[int, int, float]:
        self.host.seconds.clear()
        start = time.perf_counter()
        frames = calls = 0
        while time.perf_counter() - start < seconds:
            frames += self.call()
            calls += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return frames, calls, time.perf_counter() - start

    def measure(self, seconds: float) -> Dict[str, float]:
        frames, calls, window = self.run_window(seconds)
        self.summary = (f"prepare: {calls} calls, {frames} frames in "
                        f"{window:.4f} s")
        return {"prepare_frames_per_s": frames / window}

    def measure_traced(self, seconds: float) -> Reading:
        frames, calls, window = self.run_window(seconds)
        host = dict(self.host.seconds)
        self.summary = (f"prepare, untraced: {calls} calls, {frames} frames "
                        f"in {window:.4f} s")

        def one_call() -> int:
            self.call()
            return 1

        trace, units = traced(one_call, self.device, "prepare_worker")
        return Reading(trace, units, len(self.frames), calls, window,
                       self.config, {}, 1,
                       host_ms={k: [v * 1e3] for k, v in host.items()},
                       extra={"cube": self.traffic["cube"]})

    # -- the check ---------------------------------------------------------
    def finish(self) -> None:
        del self.processor
        program.release(self.device)

    def _sample(self) -> List[Tuple[str, str]]:
        """(output directory, frame) pairs drawn from the seed."""
        rng = np.random.default_rng([self.seed, 6])
        pairs = [(d, f) for d in self.outputs for f in self.frames]
        picks = rng.choice(len(pairs), size=min(int(self.traffic["sample"]),
                                                len(pairs)), replace=False)
        return [pairs[i] for i in sorted(picks)]

    def _frame_dir(self, out: str, frame: str) -> str:
        from glob import glob
        found = glob(os.path.join(out, "*", raw_tree.SEQUENCE, frame))
        return found[0] if len(found) == 1 else ""

    def close(self) -> None:
        """Removes the raw tree and every destination."""
        shutil.rmtree(self.work, ignore_errors=True)

    def check(self) -> Dict[str, float]:
        return self.compare(self._sample())

    def compare(self, sample, planes_of=None) -> Dict[str, float]:
        """The widest relative gap of a value channel of the planes, the
        share of cells whose doppler lookup differs, and the count of
        other files that differ from the reference's."""
        from reference import prepare_ref, radar_ref

        refs = {}
        plane_gap = lookup = 0.0
        mismatched = 0
        for out, frame in sample:
            src = self.tree.source_of(frame)
            k = id(src)
            if k not in refs:
                cube = torch.from_numpy(src.cube).to(self.device)
                refs[k] = [p.cpu().numpy() for p in
                           radar_ref.planes(cube, torch.float32)]
            d = self._frame_dir(out, frame)
            if not d or sorted(os.listdir(d)) != sorted(FILES):
                mismatched += 1
                continue
            ours = (planes_of(src) if planes_of is not None else
                    [np.load(os.path.join(d, f"{n}.npy"))
                     for n in ("ra", "ea")])
            for o, r in zip(ours, refs[k]):
                g, m = prepare_ref.plane_gaps(o, r)
                plane_gap, lookup = max(plane_gap, g), max(lookup, m)
            mismatched += prepare_ref.files_mismatch(
                d, src, self.config, self.tree.image_hw,
                "header\n" + raw_tree.LABEL_LINES, raw_tree.DESCRIPTION)
        return {"prepare_plane_gap": plane_gap,
                "prepare_lookup_mismatch": lookup,
                "prepare_files_mismatch": float(mismatched)}

    def control(self) -> Dict[str, float]:
        """The reference in bfloat16 (the precision below the
        configuration's float32) in the program's place."""
        from reference import radar_ref

        def planes_of(src):
            cube = torch.from_numpy(src.cube).to(self.device)
            return [p.cpu().numpy() for p in
                    radar_ref.planes(cube, torch.bfloat16)]

        return self.compare(self._sample(), planes_of)
