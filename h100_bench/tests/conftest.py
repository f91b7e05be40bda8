"""Settings of the benchmark's own tests
(``python -m pytest h100_bench/tests``).

Registers the ``card`` marker: a test that needs a CUDA card carries it and
skips inside its ``card`` fixture where torch sees none. Nothing here or in
the tests imports JAX or the JAX package.
"""

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for path in (str(ROOT), str(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch sees none")
    return torch.device("cuda", 0)


# The tiny configurations, by backbone family of the camera: the test
# suite's cells run the ResNet one; the Swin one runs where the camera's
# backbone is what a test holds the harness to.
TINY = {"resnet": "tiny_kradar.json", "swin": "tiny_kradar_swin.json"}


def load_tiny(kind: str) -> dict:
    return json.loads((BENCH / "tests" / TINY[kind]).read_text())


@pytest.fixture
def tiny_config():
    return load_tiny("resnet")
