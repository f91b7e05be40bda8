"""The check's control on the card, at each cell's own size: the
reference computed in the precision below the configuration's, in the
program's place, has to fail the check on every seed, while the program
passes it. Each seed runs in a process of its own (``calibrate.py``): the
program keeps one memory pool for all CUDA graphs of a process, and the
third model that one process builds fails its capture. Skips without a
card."""

import json
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT
from harness import spec

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name, card):
    cell = spec.load_cell(ROOT, name)
    out = subprocess.run(
        [sys.executable, str(BENCH / "calibrate.py"), "--workload", name,
         "--seeds", ",".join(map(str, SEEDS)), "--control", str(len(SEEDS))],
        capture_output=True, text=True, timeout=1800, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    rows = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    assert [row["seed"] for row in rows] == list(SEEDS)
    for row in rows:
        ours = {k: row[k] for k in cell.limits}
        assert all(ours[k] <= cell.limits[k] for k in ours), (row["seed"],
                                                              ours)
        control = row["control"]
        assert any(control[k] > cell.limits[k] for k in control), (
            row["seed"], control)
