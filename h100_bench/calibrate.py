"""Readings that the correctness limits are set from, on the card.

    python3 h100_bench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--seconds 2] [--control 3] [--out readings.jsonl] [--file <config>]

For every seed, in a process of its own: the cell's set-up and a window
of ``--seconds`` through its timed path, then its check, exactly as a run
of ``run.py`` does; for the first ``--control`` seeds also the control
(the reference in the precision below the configuration's, in the
program's place). One JSON line per seed. ``--file`` runs the cell's
traffic on another configuration file, one that is in no cell yet (its
readings are held against the cell's limits). The benchmark's own runs
never run this.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))


def reading(cell, seed: int, seconds: float, control: bool) -> dict:
    """One seed's readings in this process."""
    import torch

    from harness import program, spec

    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    driver = spec.generator(cell).Driver(cell.config, cell.input_shapes,
                                         cell.traffic, seed, device)
    driver.setup()
    driver.measure(seconds)
    driver.finish()
    try:
        row = {"workload": cell.name, "config": cell.config_name,
               "seed": seed, **driver.check()}
        if hasattr(driver, "last_reference"):
            ref = driver.last_reference
            row["losses"] = driver.losses
            row["reference_losses"] = ref["losses"]
            gaps = driver.change_gaps(driver.ours(), ref)
            row["change_worst"] = sorted(gaps.items(),
                                         key=lambda kv: -kv[1])[:3]
            row["change_worst_norms"] = {
                k: (driver.ours()["change"][k], ref["change"][k])
                for k, _ in row["change_worst"]}
        if control:
            row["control"] = driver.control()
    finally:
        getattr(driver, "close", lambda: None)()
    row["seconds"] = time.perf_counter() - t0
    del driver
    program.release(device)
    return row


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--control", type=int, default=3)
    parser.add_argument("--out", default=None)
    parser.add_argument("--file", default=None)
    args = parser.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    if len(seeds) > 1:
        # One process per seed: the program keeps one memory pool for all
        # CUDA graphs of a process, and the third model that one process
        # builds fails its capture (PERF.md, section 7).
        for i, seed in enumerate(seeds):
            cmd = [sys.executable, str(Path(__file__).resolve()),
                   "--workload", args.workload, "--seeds", str(seed),
                   "--seconds", str(args.seconds),
                   "--control", str(int(i < args.control))]
            for flag in ("out", "file"):
                if getattr(args, flag):
                    cmd += [f"--{flag}", getattr(args, flag)]
            code = subprocess.run(cmd).returncode
            if code:
                return code
        return 0

    import dataclasses

    from harness import spec

    cell = spec.load_cell(HERE.parent, args.workload)
    if args.file:
        cell = dataclasses.replace(
            cell, config=json.loads(Path(args.file).read_text()),
            config_name=Path(args.file).stem)
    row = reading(cell, seeds[0], args.seconds, args.control > 0)
    print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
