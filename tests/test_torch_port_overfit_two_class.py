"""The port learns two classes: tests/test_overfit_metrics.py's two-class
overfit (a Sedan at 20 m, a "Bus or Truck" at 45 m; ``num_classes`` 3)
through the port, on the CPU.

As tests/test_torch_port_overfit.py: the port prepares the fixture,
starts from the JAX test's own seed-0 variables carried across, trains 80
epochs in float32 with ``dst=None``, and every floor of the JAX test holds
(mGIoU above -0.2: the reference's off-class -1 columns cap the two-class
reading at 0), with both foreground classes among the matched targets
and two or more classes present in every sample.
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


def test_two_class_overfit_meets_the_jax_floors(tmp_path):
    history, readings, _ = po.port_overfit(str(tmp_path), two_class=True)
    po.report(history, readings)
    assert {m["class"] for m in readings["matched"]} == {1, 2}
    assert floor_failures(readings, history) == []
