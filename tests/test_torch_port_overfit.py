"""The port learns: tests/test_overfit_metrics.py's single-class overfit
(two Sedans per frame, at 20 m and 45 m) through the port, on the CPU.

The port prepares the fixture, starts from the variables that the JAX
package's trainer draws in that test (seed 0, carried across by
``state_dict_from_flax``; torch_port_overfit.py) and trains 80 epochs in
float32 through ``CentralizedTrainer.train`` with ``dst=None``, so no
checkpoint is written (at this config one is about 105 MB). Every floor
of the JAX test holds, and every sample has two classes among its targets
and predicted labels, so the mAP reading comes from the metric's
selection and not from its rule of 1.0 for fewer classes.

The recipe is fragile to the draw in both packages: from their own draws
at seeds 0-7, each met these floors at 3 of 8 seeds on the CPU. From the
JAX test's own weights both meet them.
"""

import pytest
import torch

import torch_port_overfit as po
from chip_smoke import floor_failures


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_overfit_meets_the_jax_floors(tmp_path):
    history, readings, _ = po.port_overfit(str(tmp_path), two_class=False)
    po.report(history, readings)
    assert len(readings["matched"]) == 4  # two boxes in each of 2 frames
    assert floor_failures(readings, history) == []
