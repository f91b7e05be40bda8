"""Training traffic: the train CLI's step on seeded batches.

Parameters (the mix's ``.json``): ``batch`` frames per step; ``pool``
distinct seeded batches, fed in turn; ``boxes`` the [least, most] real
targets of a frame (each frame draws its count); ``checked_steps`` the
first steps of set-up that the reference follows; ``warmup_steps``
further steps before the window; ``trace_steps`` steps inside the
profiler window of a ``--trace 1`` run.

The step is the one ``CentralizedTrainer.train`` runs for every batch
with the configuration's own ``train`` section: the program's copy in,
``train_step`` (forward in train mode, the host's Hungarian matching,
loss, metric, the ``.tolist()`` of the update gate and the backward),
then AdamW's update, ``zero_grad`` and the schedule's step. Set-up builds
one model and one optimizer, runs the first steps through the same call
and feed, and hands both to the window. The dropout masks come from
torch's generator, seeded from ``--seed`` before the first step.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from harness import program, weights
from harness.reading import Reading
from harness.inputs import make_requests
from harness.trace import dpft_ranges, span, traced

Batch = Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]


def make_targets(config: dict, batch: int, boxes: List[int],
                 rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Padded targets of ``batch`` frames, each with a seeded number of
    real boxes in ``boxes`` (inclusive) inside the radar's field of view:
    class 1 (class 0 is the padding's background), centres 5-65 m ahead,
    sizes of cars, any yaw."""
    M = config["data"]["max_boxes"]
    C = config["data"]["num_classes"]
    n = rng.integers(boxes[0], boxes[1] + 1, size=batch)
    mask = np.arange(M)[None, :] < n[:, None]
    cls = np.zeros((batch, M, C), np.float32)
    cls[..., 0] = np.where(mask, 0.0, 1.0)
    cls[..., 1] = np.where(mask, 1.0, 0.0)
    center = np.stack([rng.uniform(5, 65, (batch, M)),
                       rng.uniform(-15, 15, (batch, M)),
                       rng.uniform(-1, 2, (batch, M))], -1)
    size = np.stack([rng.uniform(3.5, 5.0, (batch, M)),
                     rng.uniform(1.6, 2.1, (batch, M)),
                     rng.uniform(1.3, 1.9, (batch, M))], -1)
    yaw = rng.uniform(-np.pi, np.pi, (batch, M))
    return {"gt_class": cls, "gt_center": center.astype(np.float32),
            "gt_size": size.astype(np.float32),
            "gt_angle": np.stack([np.sin(yaw), np.cos(yaw)],
                                 -1).astype(np.float32),
            "gt_mask": mask}


def make_batches(config: dict, input_shapes, traffic: dict, seed: int
                 ) -> List[Batch]:
    pool, B = int(traffic["pool"]), int(traffic["batch"])
    inputs = make_requests(config, input_shapes, pool, B, seed)
    rng = np.random.default_rng([seed, 4])
    return [(x, make_targets(config, B, traffic["boxes"], rng))
            for x in inputs]


def _torch_seed(seed: int) -> int:
    return int(seed) % (2 ** 63)


class Driver:
    """Training cells: ``train_frames_per_s`` and, traced, the train
    readings."""

    def __init__(self, config: dict, input_shapes, traffic: dict, seed: int,
                 device: torch.device):
        self.config, self.input_shapes = config, input_shapes
        self.traffic, self.seed, self.device = traffic, seed, device
        self.batch = int(traffic["batch"])
        self.attempted = self.failed = 0
        self.steps_done = 0
        self.match_ms: List[float] = []

    # -- set-up ------------------------------------------------------------
    def setup(self) -> None:
        from dpft_tpu_torch import parallel
        from dpft_tpu_torch.evaluation.evaluator import to_device
        from dpft_tpu_torch.training.scheduler import as_step_schedule
        from dpft_tpu_torch.training.trainer import CentralizedTrainer

        clock = program.PhaseClock()
        program.full_float32()
        self._to_device = to_device
        self.model, self.template = program.build_model(
            self.config, self.device, self.seed)
        clock.mark("model")
        self.trainer = CentralizedTrainer.from_config(self.config)
        clock.mark("trainer")
        self.net = parallel.distribute(self.model)
        self.optimizer = self.trainer.optimizer_factory(
            self.model.parameters())
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, as_step_schedule(self.trainer.scheduler_factor,
                                             int(self.traffic["pool"])))
        self.optimizer.zero_grad(set_to_none=True)
        self.names = {p: k for k, p in self.model.named_parameters()}
        self._wrap_match()
        clock.mark("optimizer")
        self.batches = make_batches(self.config, self.input_shapes,
                                    self.traffic, self.seed)
        clock.mark("batches")

        torch.manual_seed(_torch_seed(self.seed))
        self.losses: List[float] = []
        for i in range(int(self.traffic["checked_steps"])):
            self.losses.append(self.step()["loss"])
            if i == 0:
                clock.mark("first_step")
                self.grad1 = self._first_gradient_norms()
        self.change3 = self._change_norms()
        for _ in range(int(self.traffic["warmup_steps"])):
            self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        clock.mark("warmup")
        self.phases = clock.phases

    def _wrap_match(self) -> None:
        """Times the host's matching (``Loss.match``) on the host clock."""
        loss = self.trainer.loss_fn
        inner = loss.match

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            with span("bench.match"):
                out = inner(*args, **kwargs)
            self.match_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        loss.match = timed

    def _first_gradient_norms(self) -> Dict[str, float]:
        """Per leaf, the first gradient as AdamW received it: its first
        moment after one update over (1 - beta1)."""
        beta1 = self.optimizer.param_groups[0]["betas"][0]
        out = {}
        for p, name in self.names.items():
            state = self.optimizer.state.get(p)
            if state and "exp_avg" in state:
                out[name] = float(torch.linalg.vector_norm(
                    state["exp_avg"].double())) / (1 - beta1)
        return out

    def _change_norms(self) -> Dict[str, float]:
        start = weights.draw(self.template, self.seed, self.device)
        return {name: float(torch.linalg.vector_norm(
                    (p.detach() - start[name]).double()))
                for p, name in self.names.items()}

    def step(self) -> Dict[str, float]:
        x, t = self.batches[self.steps_done % len(self.batches)]
        self.steps_done += 1
        self.attempted += 1
        with span("bench.copy_in"):
            batch = self._to_device(x, self.device)
            targets = self._to_device(t, self.device)
        scalars = self.trainer.train_step(self.net, batch, targets)
        if scalars["loss"] > 0:
            with span("bench.optimizer"):
                self.optimizer.step()
                self.optimizer.zero_grad(set_to_none=True)
                self.scheduler.step()
        return scalars

    # -- the window --------------------------------------------------------
    def run_window(self, seconds: float) -> Tuple[int, float]:
        start = time.perf_counter()
        steps = 0
        while time.perf_counter() - start < seconds:
            self.step()
            steps += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return steps, time.perf_counter() - start

    def measure(self, seconds: float) -> Dict[str, float]:
        steps, window = self.run_window(seconds)
        self.summary = (f"train: {steps} steps of {self.batch} frames in "
                        f"{window:.4f} s, {window / steps * 1e3:.4f} ms per "
                        f"step")
        return {"train_frames_per_s": steps * self.batch / window}

    def measure_traced(self, seconds: float) -> Reading:
        self.match_ms.clear()
        steps, window = self.run_window(seconds)
        match_ms = list(self.match_ms)
        self.summary = (f"train, untraced: {steps} steps in {window:.4f} s")
        ranges = dpft_ranges(self.model)
        calls = int(self.traffic["trace_steps"])

        def body() -> int:
            for _ in range(calls):
                self.step()
            return calls

        try:
            trace, units = traced(body, self.device, "backward")
        finally:
            ranges.remove()
        return Reading(trace, units, self.batch, steps, window, self.config,
                       self.input_shapes, self.batch,
                       host_ms={"match": match_ms})

    # -- the check ---------------------------------------------------------
    def finish(self) -> None:
        self.leaf_names = list(self.names.values())
        del self.names, self.net, self.model, self.optimizer, self.scheduler
        del self.trainer
        program.release(self.device)

    def reference(self, tf32: bool) -> Dict[str, object]:
        """The reference's first steps from the same weights, batches and
        dropout seed: losses, first-gradient and change norms per leaf."""
        from reference import dpft_ref, train_ref

        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            p = weights.draw(self.template, self.seed, self.device)
            start = {k: p[k].clone() for k in self.leaf_names}
            leaves = {k: p[k].requires_grad_() for k in self.leaf_names}
            opt_cfg = self.config["train"]["optimizer"]
            opt = train_ref.AdamW(leaves, lr=float(opt_cfg["lr"]),
                                  weight_decay=float(
                                      opt_cfg.get("weight_decay", 1e-2)))
            w = self.config["train"]["loss_weights"]
            ctx = dpft_ref.Ctx(train=True, dropout_p=float(
                self.config["model"]["fuser"].get("dropout", 0.0)))
            torch.manual_seed(_torch_seed(self.seed))
            losses, grad1 = [], {}
            for i in range(int(self.traffic["checked_steps"])):
                x, t = self.batches[i % len(self.batches)]
                batch = {k: torch.as_tensor(v).to(self.device)
                         for k, v in x.items()}
                tgt = {k: torch.as_tensor(v).to(self.device)
                       for k, v in t.items()}
                out = dpft_ref.forward(p, self.config, batch, ctx)
                pairs = train_ref.match(out, tgt, w)
                total, _ = train_ref.set_loss(out, tgt, pairs, w)
                keys = list(leaves)
                grads = torch.autograd.grad(total, [leaves[k] for k in keys],
                                            allow_unused=True)
                grads = {k: g for k, g in zip(keys, grads) if g is not None}
                if i == 0:
                    grad1 = train_ref.leaf_norms(grads)
                opt.step(grads)
                losses.append(float(total.detach()))
            change = {k: float(torch.linalg.vector_norm(
                          (leaves[k].detach() - start[k]).double()))
                      for k in start}
            return {"losses": losses, "grad1": grad1, "change": change}
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev

    @staticmethod
    def compare(ours: Dict[str, object], ref: Dict[str, object]
                ) -> Dict[str, float]:
        """The first step's loss, the worst leaf's first-gradient norm,
        and the median and the worst leaf's change norm, each against the
        reference's.

        The later steps' losses are not compared, and the worst leaf's
        change only against a loose limit: AdamW's first update is
        ``lr * sign(g)``, so elements whose first gradient is rounding
        move by whole learning-rate steps either way, and both sides'
        later gradients part by rounding that grows step by step
        (PERF.md, §2). A leaf left unmoved, or moved double, reads 1."""
        from reference import train_ref

        g_ref = ref["grad1"]
        missing = set(g_ref) ^ set(ours["grad1"])
        change = list(Driver.change_gaps(ours, ref).values())
        return {
            "train_loss1_gap": train_ref.relative(ours["losses"][0],
                                                  ref["losses"][0]),
            "train_grad_gap": (float("inf") if missing else
                               train_ref.norm_gap(ours["grad1"], g_ref)),
            "train_change_gap": float(np.median(change)),
            "train_change_worst_gap": float(max(change)),
        }

    @staticmethod
    def change_gaps(ours: Dict[str, object], ref: Dict[str, object]
                    ) -> Dict[str, float]:
        """Per leaf that the reference moves, the gap of the program's
        change norm from the reference's over the reference's. Leaves whose
        reference gradient is under a thousandth of the median leaf's move
        under AdamW by round-off alone and are left out."""
        from reference import train_ref

        g_ref = ref["grad1"]
        median = float(np.median(list(g_ref.values())))
        return {k: train_ref.relative(ours["change"][k], ref["change"][k])
                for k, g in g_ref.items() if g >= 1e-3 * median}

    def ours(self) -> Dict[str, object]:
        return {"losses": self.losses, "grad1": self.grad1,
                "change": self.change3}

    def check(self) -> Dict[str, float]:
        self.last_reference = self.reference(tf32=False)
        return self.compare(self.ours(), self.last_reference)

    def control(self) -> Dict[str, float]:
        """The reference in TF32 in the program's place, against the
        float32 reference."""
        return self.compare(self.reference(tf32=True),
                            self.reference(tf32=False))
