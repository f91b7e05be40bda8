"""The per-layer metrics that read the program's own spans and counter
(``dpft_tpu_torch/utils/profiling.py``), at a tiny size on the CPU through
the harness's own run: each reads in the traced run of its cells, an
untraced run leaves the program's totals as they were, and the metrics
that read the harness's hooks and wrappers read as they do with the
program's spans switched off."""

import pytest
import torch

from test_h100_bench_cells import CELLS, drive, tiny_cell

SPANS = ("frontend.host_ms.serve", "decoder.host_ms.serve",
         "backward.host_ms.train", "optimizer.host_ms.train",
         "gate.host_ms.train", "sync.host_syncs_per_step.train",
         "prepare.cube_copy_share")


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _without_spans(monkeypatch):
    """The program as it was before its spans: every span does nothing,
    every count is dropped, and the measuring module has no totals."""
    import contextlib
    import importlib

    from dpft_tpu_torch.utils import profiling

    def span(name, id=None):
        return contextlib.nullcontext()

    def count(name, n=1):
        return None

    for module in ("dpft_tpu_torch.utils.profiling",
                   "dpft_tpu_torch.models.dpft",
                   "dpft_tpu_torch.models.fusers.mpfusion",
                   "dpft_tpu_torch.data.kradar.processor"):
        monkeypatch.setattr(importlib.import_module(module), "span", span)
    for module in ("dpft_tpu_torch.utils.profiling",
                   "dpft_tpu_torch.ops.hungarian", "dpft_tpu_torch.ops.boxes",
                   "dpft_tpu_torch.ops.iou", "dpft_tpu_torch.ops.deform_attn",
                   "dpft_tpu_torch.models.layers.ms_deform_attn",
                   "dpft_tpu_torch.data.kradar.processor"):
        monkeypatch.setattr(importlib.import_module(module), "count", count)
    monkeypatch.delattr(profiling, "span_totals")
    monkeypatch.delattr(profiling, "counters")


@pytest.mark.parametrize("name", CELLS)
def test_program_span_metrics_read_in_the_traced_run(name, tiny_config):
    cell = tiny_cell(name, tiny_config)
    ours = [m["name"] for m in cell.per_layer if m["name"] in SPANS]
    assert ours, "every cell reports one of the program's span metrics"
    result, _ = drive(cell, trace=True)
    assert result["correct"]
    for metric in ours:
        assert metric in result["metrics"], metric
        assert result["metrics"][metric]["value"] > 0, metric
    if cell.traffic["generator"] == "train":
        # Per step on one rank: 17 in the matching, 13 in the metric and
        # the gate's read-back (PERF.md, section 3).
        value = result["metrics"]["sync.host_syncs_per_step.train"]["value"]
        assert value == 31


@pytest.mark.parametrize("name", CELLS)
def test_untraced_run_adds_nothing_to_the_program_totals(name, tiny_config):
    from dpft_tpu_torch.utils import profiling

    cell = tiny_cell(name, tiny_config)
    before = (profiling.span_totals(), profiling.counters())
    result, _ = drive(cell)
    assert result["correct"]
    assert (profiling.span_totals(), profiling.counters()) == before


@pytest.mark.parametrize("name", CELLS)
def test_hooked_metrics_read_as_without_the_program_spans(
        name, tiny_config, monkeypatch):
    cell = tiny_cell(name, tiny_config)
    hooked = {m["name"] for m in cell.per_layer} - set(SPANS)
    with_spans, _ = drive(cell, trace=True)
    _without_spans(monkeypatch)
    without, _ = drive(cell, trace=True)
    assert with_spans["correct"] and without["correct"]
    read = set(with_spans["metrics"]) & hooked
    assert read, "the CPU run reads some of the hooked metrics"
    assert read == set(without["metrics"]) & hooked
    for k in read:
        assert with_spans["metrics"][k]["value"] >= 0
    # A program without spans gives the new metrics nothing to read.
    assert not set(without["metrics"]) & set(SPANS)
