"""Holds the harness's FLOP count (``harness/flops.py``) against PyTorch's
``FlopCounterMode`` over the program at a configuration's own sizes.

    python3 h100_bench/flops_check.py --config kradar --batch 1
    python3 h100_bench/flops_check.py --file h100_bench/tests/kradar_swinb.json \
        --batch 4 --step

``--config`` names a configuration of ``BENCHMARK.json``; ``--file`` takes
a configuration file that is in no cell yet. ``--step`` counts a train
step (the forward in train mode and the backward of a loss of the
outputs) instead of the eval forward. Prints one JSON line; exits 1 where
the two differ. Needs a CUDA card at the published sizes; the test suite
runs the same comparisons at a tiny size on the CPU.
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))


def counted(config, shapes, batch, device, step: bool) -> int:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from harness import program
    from harness.inputs import make_requests

    model, _ = program.build_model(config, device, seed=0)
    req = make_requests(config, shapes, 1, batch, seed=0)[0]
    tensors = {k: torch.as_tensor(v).to(device) for k, v in req.items()}
    counter = FlopCounterMode(display=False)
    if step:
        model.train()
        with counter:
            out = model(tensors)
            sum(v.sum() for v in out.values()).backward()
        return counter.get_total_flops()
    # The counter's module tracker hooks inputs that require grad; with no
    # parameter requiring it the forward is counted alone.
    model.requires_grad_(False)
    with counter:
        model(tensors)
    return counter.get_total_flops()


def main() -> int:
    parser = argparse.ArgumentParser()
    which = parser.add_mutually_exclusive_group(required=True)
    which.add_argument("--config")
    which.add_argument("--file")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--step", action="store_true")
    args = parser.parse_args()

    import torch

    from harness import flops

    if args.file:
        path = Path(args.file)
    else:
        bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
        entry = next(c for c in bench["configs"]
                     if c["name"] == args.config)
        path = HERE.parent / entry["file"]
    config = json.loads(path.read_text())
    shapes = config["bench"]["input_shapes"]
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    theirs = counted(config, shapes, args.batch, device, args.step)
    count = flops.step_flops if args.step else flops.forward_flops
    ours = count(config, shapes, args.batch)
    print(json.dumps({"config": args.config or args.file,
                      "batch": args.batch, "step": args.step,
                      "flop_counter": theirs, "harness": ours,
                      "equal": theirs == ours}))
    return 0 if theirs == ours else 1


if __name__ == "__main__":
    sys.exit(main())
