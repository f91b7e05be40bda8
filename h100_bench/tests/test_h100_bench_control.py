"""The check's control on the card, at each cell's own size: the
reference computed in the precision below the configuration's, in the
program's place, has to fail the check on every seed, while the program
passes it. Skips without a card."""

import json

import pytest
import torch

from conftest import ROOT
from harness import spec

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name, card):
    cell = spec.load_cell(ROOT, name)
    for seed in SEEDS:
        driver = spec.generator(cell).Driver(cell.config, cell.input_shapes,
                                             cell.traffic, seed, card)
        driver.setup()
        driver.measure(2.0)
        driver.finish()
        try:
            ours = driver.check()
            control = driver.control()
        finally:
            getattr(driver, "close", lambda: None)()
        assert all(ours[k] <= cell.limits[k] for k in ours), (seed, ours)
        assert any(control[k] > cell.limits[k] for k in control), (
            seed, control)
        del driver
        torch.cuda.empty_cache()
