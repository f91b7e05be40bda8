"""The port's whole workflow against the JAX package's, on the CPU:
prepare -> train -> evaluate -> export on the K-Radar fixture.

1. ``dpft_tpu_torch.prepare.main`` prepares the overfit recipe's raw tree
   (tests/test_overfit_metrics.py: two large Sedans per frame).
2. The port trains the single-class overfit from the JAX test's own
   seed-0 variables (torch_port_overfit.py) and ``registry.save`` writes
   its one checkpoint, whose boxes overlap their targets.
3. ``python -m dpft_tpu_torch.evaluate --device cpu`` evaluates it.
4. The JAX package's evaluator evaluates the same file, carried to flax by
   its own importer (``models/torch_checkpoint.py:convert_full_model``,
   through ``registry.load``): the metric over the test split and the
   exporter, without the 300-repetition latency and the FLOP count.
5. mAP and mGIoU of the port's ``results.json`` equal JAX's within 1e-6;
   the exported K-Radar trees hold the same files with the same lines,
   the same text fields and numbers within 1e-4, and every gts line has
   the 15 fields of tests/test_e2e.py.
6. ``python -m dpft_tpu_torch.export --device cpu`` exports the same
   checkpoint; the loaded program gives the eager forward's outputs on
   the fixture's test batch, bit for bit.
"""

import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_overfit as po
from chip_smoke import FLOOR_MAP, floor_failures

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
KEYS = ("class", "center", "size", "angle")


def _cli(*args):
    proc = subprocess.run(
        [sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="",
                 JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    from dpft_tpu_torch import prepare
    from dpft_tpu_torch.models import registry

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = str(tmp_path_factory.mktemp("port_e2e"))
    config = po.overfit_config(two_class=False)
    config["train"]["logging"] = "epoch"  # the evaluator's results.json
    cfg = osp.join(root, "config.json")
    with open(cfg, "w") as f:
        json.dump(config, f)
    src, processed = po.overfit_paths(root)
    po.raw_tree(root, two_class=False)
    prepare.main(src, cfg, processed, device="cpu")
    history, readings, model = po.port_overfit(root, False, config)
    po.report(history, readings)
    assert floor_failures(readings, history) == []
    ckpt = osp.join(root, "log", "overfit", "checkpoints",
                    f"overfit_checkpoint_{len(history) - 1:04d}.pt")
    registry.save(model, config, ckpt)
    torch.set_num_threads(threads)
    return root, processed, cfg, config, ckpt


def _jax_evaluate(config, processed, ckpt, dst):
    """The JAX package's evaluator on the port's checkpoint: its load
    (the importer), its jitted forward, its metric and exporter."""
    from dpft_tpu.data import init as init_dataset
    from dpft_tpu.data import load as load_dataset
    from dpft_tpu.evaluation.evaluator import build_evaluator
    from dpft_tpu.models import registry

    evaluator = build_evaluator(config)
    model, variables, epoch, timestamp = registry.load(ckpt, config=config)
    variables = registry.model_collections(variables)
    loader = load_dataset(init_dataset("kradar", src=processed,
                                       split="test", config=config),
                          config=config, shuffle=False, pad_last=True)
    return evaluator.evaluate_one_epoch(
        epoch, evaluator._forward(model, variables), loader,
        dst=osp.join(dst, timestamp))


def _tree(root):
    return sorted(osp.relpath(osp.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _same_lines(got_path, want_path):
    with open(got_path) as f:
        got = f.read().splitlines()
    with open(want_path) as f:
        want = f.read().splitlines()
    assert len(got) == len(want), (got_path, got, want)
    for g, w in zip(got, want):
        g, w = g.split(), w.split()
        assert len(g) == len(w), (got_path, g, w)
        for a, b in zip(g, w):
            try:
                x, y = float(a), float(b)
            except ValueError:
                assert a == b, (got_path, g, w)
                continue
            assert abs(x - y) <= 1e-4, (got_path, g, w)


def test_evaluate_equals_the_jax_evaluator(chain):
    root, processed, cfg, config, ckpt = chain
    port_dst, jax_dst = osp.join(root, "port_eval"), osp.join(root, "jax_eval")
    _cli("dpft_tpu_torch.evaluate", "--src", processed, "--cfg", cfg,
         "--checkpoint", ckpt, "--dst", port_dst, "--device", "cpu")
    with open(osp.join(port_dst, "overfit", "results.json")) as f:
        got = json.load(f)
    want = _jax_evaluate(config, processed, ckpt, jax_dst)
    print(f"port {got}\njax {want}")
    for key in ("mAP", "mGIoU"):
        assert abs(got[key] - want[key]) <= 1e-6, (key, got, want)
    # Real overlap on the test frame, not the metric's rule.
    assert got["mAP"] > FLOOR_MAP and got["mGIoU"] > 0, got

    exports = osp.join("overfit", "exports", "kradar")
    port_tree, jax_tree = (osp.join(d, exports) for d in (port_dst, jax_dst))
    files = _tree(port_tree)
    assert files == _tree(jax_tree)
    assert sorted(os.listdir(port_tree)) == ["0.0", "0.3", "0.5", "0.7",
                                             "0.9"]
    for rel in files:
        _same_lines(osp.join(port_tree, rel), osp.join(jax_tree, rel))
        if f"{os.sep}gts{os.sep}" in rel:
            with open(osp.join(port_tree, rel)) as f:
                for line in f.read().splitlines():
                    fields = line.split()
                    assert fields[0] == "sed" and len(fields) == 15, line
    preds = osp.join(port_tree, "0.5", "all", "preds", "000000.txt")
    with open(preds) as f:
        assert [line.split()[0] for line in f] == ["sed", "sed"]


def test_export_gives_the_eager_outputs(chain):
    from dpft_tpu_torch.data import init as init_dataset
    from dpft_tpu_torch.data import load as load_dataset
    from dpft_tpu_torch.export import load_exported
    from dpft_tpu_torch.models import registry

    root, processed, cfg, config, ckpt = chain
    dst = osp.join(root, "model.pt2")
    _cli("dpft_tpu_torch.export", "--src", processed, "--cfg", cfg,
         "--checkpoint", ckpt, "--dst", dst, "--batch", "1", "--device",
         "cpu")
    program = load_exported(dst)
    model, config, _, _ = registry.load(ckpt, device="cpu")
    config = dict(config, train=dict(config["train"], batch_size=1))
    batch, _ = next(iter(load_dataset(
        init_dataset("kradar", src=processed, split="test", config=config),
        config=config, shuffle=False, pad_last=True)))
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    got = program.module()(batch)
    with torch.inference_mode():
        want = model(batch)
    for key in KEYS:
        assert got[key].shape[0] == 1
        assert torch.isfinite(got[key]).all(), key
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0,
                                   msg=key)
