"""Batch and dtype scaling of the bench: one fresh process per cell.

    python -m dpft_tpu_torch.bench_scaling out.jsonl inference 1:f32 4:bf16
    python -m dpft_tpu_torch.bench_scaling out.jsonl train 8:bf16:nometric

Counterpart of ``scripts/bench_scaling.py``: it walks
``python -m dpft_tpu_torch.bench`` over (mode, batch, dtype) cells, one
after the other, each in a fresh process (so each cell's peak memory is its
own, and a cell that runs out of memory cannot poison the next), and
appends one JSON line per cell to the output file: the bench's last line
with ``mode``, ``batch``, ``dtype`` and ``wall_sec``. A cell that dies is
recorded with its ``error`` (the tail of its output): the memory wall is
part of the frontier, not a failure of the sweep. Each cell's standard
error is passed on to the sweep's.

A cell is ``<batch>:<f32|bf16>[:<variant>]``. The variant ``nometric``
sets ``BENCH_NO_METRIC=1`` (the step of ``train.logging`` null). ``hoist``
is refused, as the bench refuses ``BENCH_HOIST``: the port has no hoisted
step structure. ``BENCH_REPS`` defaults to 20 for train and 60 otherwise;
``BENCH_FLOPS`` is 1. Every cell is checked before the first one runs.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import List, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"f32": "float32", "bf16": "bfloat16"}
VARIANTS = ("", "nometric")


def parse_cell(cell: str) -> Tuple[int, str, str]:
    """(batch, dtype, variant) of ``<batch>:<dtype>[:<variant>]``."""
    batch, dtype, *rest = cell.split(":")
    variant = rest[0] if rest else ""
    if variant == "hoist":
        raise SystemExit(f"cell {cell!r}: the hoist variant selects an XLA "
                         "step structure that the port leaves out (ROADMAP.md "
                         "Queue 1 item 6)")
    if dtype not in DTYPES or variant not in VARIANTS or len(rest) > 1:
        raise SystemExit(f"cell {cell!r}: expected <batch>:<f32|bf16>"
                         "[:nometric]")
    return int(batch), dtype, variant


def run_cell(out_path: str, mode: str, batch: int, dtype: str,
             variant: str = "") -> dict:
    env = dict(os.environ, BENCH_MODE=mode, BENCH_BATCH=str(batch),
               BENCH_DTYPE=DTYPES[dtype], BENCH_FLOPS="1")
    if variant == "nometric":
        env["BENCH_NO_METRIC"] = "1"
    env.setdefault("BENCH_REPS", "20" if mode == "train" else "60")
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "dpft_tpu_torch.bench"],
                          cwd=ROOT, env=env, capture_output=True, text=True)
    sys.stderr.write(proc.stderr)  # the cell's own diagnostics
    row = {"mode": mode, "batch": batch, "dtype": dtype,
           "wall_sec": time.time() - t0}
    if variant:
        row["variant"] = variant
    last = (proc.stdout.strip().splitlines() or [""])[-1]
    try:
        row.update(json.loads(last))
    except ValueError:
        tail = (proc.stderr or proc.stdout or "").strip().splitlines()
        row["error"] = " | ".join(tail[-3:])[:400] or f"rc={proc.returncode}"
    with open(out_path, "a") as f:
        f.write(json.dumps(row) + "\n")
    print(json.dumps(row), flush=True)
    return row


def main(argv: List[str]) -> None:
    out_path, mode, *cells = argv
    for batch, dtype, variant in [parse_cell(c) for c in cells]:
        run_cell(out_path, mode, batch, dtype, variant)
    print("scaling sweep done", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
