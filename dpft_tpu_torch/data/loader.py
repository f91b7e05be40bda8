"""Batched data loader: map-style dataset -> prefetched numpy batches
(counterpart of dpft_tpu/data/loader.py).

Replaces the reference's torch DataLoader + listed_collating
(src/dprt/datasets/loader.py:10-44). Because targets are padded to static
shapes by the dataset, both inputs and targets collate to plain stacked
arrays - no ragged list-of-dicts. Sample decoding runs in a thread pool
(cv2/numpy release the GIL) with a bounded prefetch queue so host IO
overlaps device compute.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Tuple

import numpy as np

Batch = Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]


def _collate(samples) -> Batch:
    inputs = {k: np.stack([s[0][k] for s in samples]) for k in samples[0][0]}
    targets = {k: np.stack([s[1][k] for s in samples]) for k in samples[0][1]}
    return inputs, targets


class Subset:
    """Map-style view of a dataset restricted to the given indices.

    Used for multi-host data parallelism: each process wraps the full
    dataset in the Subset of its ``process_local_indices`` so the hosts
    collectively feed disjoint shards of the global batch
    (dpft_tpu.parallel.mesh). Attribute access falls through to the
    underlying dataset (max_boxes, num_classes, ...).

    ``real`` (optional, per-index bool) flags wrap-around lockstep
    padding: False rows exist only to keep hosts in step and a pad_last
    DataLoader excludes them from ``sample_mask`` so eval metrics are
    not biased by duplicated samples."""

    def __init__(self, dataset, indices, real=None):
        self.dataset = dataset
        self.indices = np.asarray(indices, np.int64)
        self.real_mask = (np.ones(len(self.indices), bool) if real is None
                          else np.asarray(real, bool))

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[int(self.indices[i])]

    def __getattr__(self, name):
        # Underscore/dunder names never delegate: during unpickle/copy
        # the instance exists before __init__ ran, and probing e.g.
        # __setstate__ would recurse through the missing self.dataset.
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.__dict__["dataset"], name)


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 0, drop_last: bool = False,
                 pad_last: bool = False, prefetch: int = 2,
                 seed: int | None = None):
        """pad_last: pad a short final batch to batch_size by repeating its
        last sample and add a ``sample_mask`` (B,) bool to the targets of
        EVERY batch (stable jit signature). Downstream consumers (loss,
        metric, exporter) weight/skip by it. This is the multi-device
        partial-batch policy: a B' < B batch cannot be laid out over the
        mesh 'data' axis and would force a tail-batch recompile; the
        reference tolerates ragged batches trivially (reference
        loader.py:37-44) so the policy is TPU-specific."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(0, num_workers)
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.prefetch = max(1, prefetch)
        self._epoch = 0
        self._seed = seed

    def _pad(self, batch: Batch, idx=None) -> Batch:
        inputs, targets = batch
        b = next(iter(inputs.values())).shape[0]
        B = self.batch_size
        mask = np.zeros(B, bool)
        # Multi-host lockstep padding (Subset.real_mask): wrap-around
        # duplicate rows are weighted out of metrics like tail padding.
        # The mask must be in THIS dataset's index space — a delegating
        # wrapper around a sharded Subset would surface the inner mask
        # with the wrong indexing, so mismatched lengths are ignored.
        real = getattr(self.dataset, "real_mask", None)
        if real is not None and len(real) != len(self.dataset):
            real = None
        mask[:b] = True if real is None or idx is None else real[idx]

        def pad(a):
            if b == B:
                return a
            return np.concatenate([a, np.repeat(a[-1:], B - b, axis=0)])

        inputs = {k: pad(v) for k, v in inputs.items()}
        targets = {k: pad(v) for k, v in targets.items()}
        targets["sample_mask"] = mask
        return inputs, targets

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = (np.random.default_rng((self._seed, self._epoch))
                   if self._seed is not None else np.random)
            rng.shuffle(order)
        self._epoch += 1
        batches = []
        for start in range(0, n, self.batch_size):
            idx = order[start:start + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                continue
            batches.append(idx)
        return batches

    def __iter__(self) -> Iterator[Batch]:
        batches = self._batch_indices()
        finish = self._pad if self.pad_last else (lambda b, idx=None: b)

        if self.num_workers == 0:
            for idx in batches:
                yield finish(_collate([self.dataset[int(i)] for i in idx]),
                             idx)
            return

        # Threaded prefetch: decode samples in a pool, assemble batches in
        # submission order with a bounded queue.
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        out: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                for idx in batches:
                    if stop.is_set():
                        return
                    futures = [pool.submit(self.dataset.__getitem__, int(i))
                               for i in idx]
                    out.put(finish(
                        _collate([f.result() for f in futures]), idx))
            except BaseException as exc:  # propagate to consumer
                out.put(exc)
            finally:
                out.put(None)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                item = out.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            pool.shutdown(wait=False, cancel_futures=True)


def load_listed(dataset, config: Dict[str, Any], drop_last: bool | None = None,
                shuffle: bool | None = None,
                pad_last: bool | None = None) -> DataLoader:
    """Builds a loader from config (reference loader.py:37-44).

    pad_last defaults to ``not drop_last``: the framework's static-shape
    contract means a ragged tail batch is never valid — jitted consumers
    would recompile and the data-axis mesh cannot shard it (a B=1 tail on
    a data=2 mesh fails device_put). Padded rows carry a ``sample_mask``
    that loss/metrics weight out and the exporter skips, so padding is
    safe for both eval and train callers; loaders that drop the tail
    (train CLI policy) have nothing to pad."""
    train_cfg = config.get("train", {})
    drop = bool(drop_last) if drop_last is not None else False
    return DataLoader(
        dataset,
        batch_size=train_cfg.get("batch_size", 1),
        shuffle=train_cfg.get("shuffle", False) if shuffle is None else shuffle,
        num_workers=config.get("computing", {}).get("workers", 0),
        drop_last=drop,
        pad_last=(not drop) if pad_last is None else pad_last,
        seed=config.get("computing", {}).get("seed"),
    )
