"""Readings that the correctness limits are set from, on the card.

    python3 h100_bench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--seconds 2] [--control 3] [--out readings.jsonl]

For every seed: the cell's set-up and a window of ``--seconds`` through
its timed path, then its check, exactly as a run of ``run.py`` does; for
the first ``--control`` seeds also the control (the reference in the
precision below the configuration's, in the program's place). One JSON
line per seed. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--control", type=int, default=3)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()

    import torch

    from harness import spec

    cell = spec.load_cell(HERE.parent, args.workload)
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        driver = spec.generator(cell).Driver(cell.config, cell.input_shapes,
                                             cell.traffic, seed, device)
        driver.setup()
        driver.measure(args.seconds)
        driver.finish()
        try:
            row = {"workload": cell.name, "seed": seed, **driver.check()}
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
            if i < args.control:
                row["control"] = driver.control()
        finally:
            getattr(driver, "close", lambda: None)()
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
        del driver
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
