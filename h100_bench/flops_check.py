"""Holds the harness's FLOP count (``harness/flops.py``) against PyTorch's
``FlopCounterMode`` over the program at a configuration's own sizes.

    python3 h100_bench/flops_check.py --config kradar --batch 1

Prints one JSON line; exits 1 where the two differ. Needs a CUDA card at
the published sizes; the test suite runs the same comparison at a tiny
size on the CPU.
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))


def forward_count(config, shapes, batch, device) -> int:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from harness import program
    from harness.inputs import make_requests

    model, _ = program.build_model(config, device, seed=0)
    # The counter's module tracker hooks inputs that require grad; with no
    # parameter requiring it the forward is counted alone.
    model.requires_grad_(False)
    req = make_requests(config, shapes, 1, batch, seed=0)[0]
    tensors = {k: torch.as_tensor(v).to(device) for k, v in req.items()}
    counter = FlopCounterMode(display=False)
    with counter:
        model(tensors)
    return counter.get_total_flops()


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--batch", type=int, default=1)
    args = parser.parse_args()

    import torch

    from harness import flops

    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == args.config)
    config = json.loads((HERE.parent / entry["file"]).read_text())
    shapes = config["bench"]["input_shapes"]
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    counted = forward_count(config, shapes, args.batch, device)
    ours = flops.forward_flops(config, shapes, args.batch)
    print(json.dumps({"config": args.config, "batch": args.batch,
                      "flop_counter": counted, "harness": ours,
                      "equal": counted == ours}))
    return 0 if counted == ours else 1


if __name__ == "__main__":
    sys.exit(main())
