"""The benchmark of ``dpft_tpu_torch`` on NVIDIA H100 cards.

    python3 h100_bench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout. The cell ``<name>`` of ``BENCHMARK.json``
names a configuration and a traffic mix; its generator
(``traffic/<generator>.py``) sets the program up from the seed (weights
drawn on the card, inputs on the host), warms up the cell's shapes, then
measures for ``--seconds``. With ``--trace 0`` the last line of standard
output carries the cell's end-to-end metrics; with ``--trace 1`` a
profiler window follows an untraced one and the line carries the
per-layer metrics (``metrics/<name>.py``), the device's busy and window
seconds and a breakdown. Then the program is dropped and what the timed
path produced is held against the plain reference
(``reference/``): each number compared, and its limit
(``checks/<workload>.json``), closes standard error and the result line.

Exits 2 without a CUDA card (or with fewer than the cell asks for), and
1 if the process holds JAX or the JAX package once the window has
closed; neither prints a result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Every build and kernel cache of the run lies inside the checkout, at
# fixed paths: only the first run of a checkout builds.
CACHE = ROOT / "build" / "bench_cache"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("USE_FLAX", "0")
# One process with few threads: the host's intra-op pools stay at one.
os.environ.setdefault("OMP_NUM_THREADS", "1")
os.environ.setdefault("MKL_NUM_THREADS", "1")
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(HERE))

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dpft_tpu")


def loaded_forbidden():
    """Top-level names of loaded modules that belong to JAX or the JAX
    package, compared whole (``dpft_tpu_torch`` is not ``dpft_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from harness import runner, spec

    t_import = time.perf_counter() - T0
    cell = spec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run: the cell needs {cell.chips} CUDA card(s); torch sees "
              f"{seen}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.init()
    t_cuda = time.perf_counter() - T0 - t_import
    driver = spec.generator(cell).Driver(cell.config, cell.input_shapes,
                                         cell.traffic, args.seed, device)
    result = runner.execute(cell, driver, args.seconds, bool(args.trace),
                            device, T0,
                            {"import": t_import, "cuda_init": t_cuda})
    print(f"run: card {power_limit()}", file=sys.stderr)
    forbidden = loaded_forbidden()
    if forbidden:
        print(f"run: JAX or the JAX package is loaded: {forbidden}",
              file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
