"""Serving traffic: frames through the program's eval forward.

Parameters (the mix's ``.json``):

- ``batch``: frames per serving call; ``pool``: distinct seeded requests,
  drawn in turn (so every seed serves the same sizes in another order);
- ``arrival``: ``"closed"``, the only kind there is: one client sends its
  next request when the last one returned;
- ``warmup_calls``: serving calls before the window (every pool entry at
  least once); ``trace_calls``: calls inside the profiler window of a
  ``--trace 1`` run; ``sample``: served requests the check compares.

A serving call hands the request's host arrays to the program's own copy
in (``evaluation/evaluator.py:to_device``), runs the model under
``torch.inference_mode`` and reads every output back to the host. Its
latency is the host clock from the hand-over to the outputs on the host.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from harness import program, weights
from harness.inputs import make_requests
from harness.reading import Reading, relative_gap
from harness.trace import dpft_ranges, span, traced


class Driver:
    """Serving cells: ``serve_p95_ms`` and, traced, the serve readings."""

    def __init__(self, config: dict, input_shapes, traffic: dict, seed: int,
                 device: torch.device):
        self.config, self.input_shapes = config, input_shapes
        self.traffic, self.seed, self.device = traffic, seed, device
        self.batch = int(traffic["batch"])
        self.attempted = self.failed = 0
        self.served: List[Tuple[int, Dict[str, np.ndarray]]] = []

    # -- set-up ------------------------------------------------------------
    def setup(self) -> None:
        from dpft_tpu_torch.evaluation.evaluator import to_device

        clock = program.PhaseClock()
        program.full_float32()
        self._to_device = to_device
        self.model, self.template = program.build_model(
            self.config, self.device, self.seed)
        clock.mark("model")
        self.requests = make_requests(self.config, self.input_shapes,
                                      int(self.traffic["pool"]), self.batch,
                                      self.seed)
        clock.mark("requests")
        for i in range(max(int(self.traffic["warmup_calls"]),
                           len(self.requests))):
            self.serve(self.requests[i % len(self.requests)])
            if i == 0:
                clock.mark("first_call")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        clock.mark("warmup")
        self.phases = clock.phases

    def serve(self, request: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        with span("bench.copy_in"):
            batch = self._to_device(request, self.device)
        with torch.inference_mode():
            out = self.model(batch)
        with span("bench.read_back"):
            return {k: v.cpu().numpy() for k, v in out.items()}

    # -- the window --------------------------------------------------------
    def run_window(self, seconds: float) -> Tuple[List[float], float]:
        """Serves until ``seconds`` have passed; the call in flight ends
        the window. Returns each request's latency (s) and the window's
        length (s)."""
        if self.traffic["arrival"] != "closed":
            raise ValueError(f"unknown arrival {self.traffic['arrival']!r}")
        lat: List[float] = []
        pool = len(self.requests)
        start = time.perf_counter()
        end = start
        i = 0
        while end - start < seconds:
            sent = time.perf_counter()
            self.attempted += 1
            out = self.serve(self.requests[i % pool])
            end = time.perf_counter()
            lat.append(end - sent)
            self.served.append((i % pool, out))
            i += 1
        return lat, end - start

    def measure(self, seconds: float) -> Dict[str, float]:
        lat, window = self.run_window(seconds)
        ms = np.asarray(lat) * 1e3
        self.summary = (f"serve: {len(ms)} requests of {self.batch} frames "
                        f"in {window:.4f} s, median {np.median(ms):.4f} ms, "
                        f"p95 {np.percentile(ms, 95):.4f} ms")
        return {"serve_p95_ms": float(np.percentile(ms, 95)),
                "serve_frames_per_s": len(ms) * self.batch / window}

    def measure_traced(self, seconds: float) -> Reading:
        lat, window = self.run_window(seconds)
        self.summary = (f"serve, untraced: {len(lat)} requests in "
                        f"{window:.4f} s")
        ranges = dpft_ranges(self.model)
        calls = int(self.traffic["trace_calls"])

        def body() -> int:
            for i in range(calls):
                out = self.serve(self.requests[i % len(self.requests)])
                self.served.append((i % len(self.requests), out))
                self.attempted += 1
            return calls

        try:
            trace, units = traced(body, self.device)
        finally:
            ranges.remove()
        return Reading(trace, units, self.batch, len(lat), window,
                       self.config, self.input_shapes, self.batch)

    # -- the check ---------------------------------------------------------
    def finish(self) -> None:
        del self.model
        program.release(self.device)

    def check(self) -> Dict[str, float]:
        """The widest relative gap of a sample of served requests from the
        plain reference, in float32 with TF32 off, on the same weights and
        inputs."""
        from reference import dpft_ref

        rng = np.random.default_rng([self.seed, 3])
        n = len(self.served)
        picks = rng.choice(n, size=min(int(self.traffic["sample"]), n),
                           replace=False)
        params = weights.draw(self.template, self.seed, self.device)
        refs: Dict[int, Dict[str, np.ndarray]] = {}
        worst = 0.0
        for i in sorted(picks):
            k, out = self.served[i]
            if k not in refs:
                batch = {key: torch.as_tensor(v).to(self.device)
                         for key, v in self.requests[k].items()}
                with torch.inference_mode():
                    r = dpft_ref.forward(params, self.config, batch)
                refs[k] = {key: v.cpu().numpy() for key, v in r.items()}
            worst = max(worst, relative_gap(out, refs[k]))
        return {"serve_out_gap": worst}

    def control(self) -> Dict[str, float]:
        """The check's control: the reference computed with TF32 (the
        precision below the configuration's float32) in the program's
        place, against the float32 reference."""
        from reference import dpft_ref

        params = weights.draw(self.template, self.seed, self.device)
        worst = 0.0
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        try:
            for k in range(min(len(self.requests), 4)):
                batch = {key: torch.as_tensor(v).to(self.device)
                         for key, v in self.requests[k].items()}
                outs = []
                for tf32 in (False, True):
                    torch.backends.cuda.matmul.allow_tf32 = tf32
                    torch.backends.cudnn.allow_tf32 = tf32
                    with torch.inference_mode():
                        r = dpft_ref.forward(params, self.config, batch)
                    outs.append({key: v.cpu().numpy() for key, v in r.items()})
                worst = max(worst, relative_gap(outs[1], outs[0]))
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev
        return {"serve_out_gap": worst}

