"""Frozen K-Radar dataset splits (counterpart of dpft_tpu/data/kradar/splits.py).

The sample-id sets ("<sequence>_<sample>") are dataset metadata extracted
from the reference's frozen split tables (reference
src/dprt/datasets/kradar/utils/split.py; produced originally by the NSGA-II
split optimizer, reference scripts/split_dataset.py). Stored compressed;
composite splits (trainval / full) are derived at load time exactly as the
reference composes them (split.py:1755,3515,20984,38527).
"""

from __future__ import annotations

import gzip
import json
import os.path as osp
from functools import lru_cache
from typing import FrozenSet

_PATH = osp.join(osp.dirname(__file__), "splits.json.gz")


@lru_cache(maxsize=1)
def _tables():
    with gzip.open(_PATH, "rb") as f:
        return json.load(f)


@lru_cache(maxsize=None)
def get_split(name: str) -> FrozenSet[str]:
    """Returns the sample-id set for a split name.

    Base names: train, val, test, mini_train, mini_val, mini_test.
    Derived: trainval = train | val; full = trainval | test (and the mini_
    variants).
    """
    t = _tables()
    if name in t:
        return frozenset(t[name])
    if name == "trainval":
        return get_split("train") | get_split("val")
    if name == "full":
        return get_split("trainval") | get_split("test")
    if name == "mini_trainval":
        return get_split("mini_train") | get_split("mini_val")
    if name == "mini_full":
        return get_split("mini_trainval") | get_split("mini_test")
    raise ValueError(f"Unknown split: {name}")
