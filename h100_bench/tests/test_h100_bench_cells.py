"""Every cell at a tiny size on the CPU through the harness's own run
(``harness.runner.execute``: set-up, window, check), its result line, and
the faults its check has to catch. The cells of ``kradar`` that run the
model also run with a Swin camera, and their check has to catch Swin's
own faults."""

import copy
import dataclasses
import json
import subprocess
import sys
import time

import pytest
import torch

from conftest import BENCH, ROOT, load_tiny
from harness import runner, spec

CPU = torch.device("cpu")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def _generator(w):
    return json.loads((BENCH / "traffic" / f"{w['traffic']}.json"
                       ).read_text())["generator"]


# The cells whose model has a camera, run again with a Swin one.
SWIN_CELLS = [w["name"] for w in SPEC["workloads"]
              if w["config"] == "kradar" and _generator(w) != "prepare"]
CELL_CASES = ([pytest.param(n, "resnet", id=n) for n in CELLS]
              + [pytest.param(n, "swin", id=f"{n}-swin") for n in SWIN_CELLS])
TINY_TRAFFIC = {
    "serve": {"warmup_calls": 2, "trace_calls": 2, "sample": 4},
    "train": {"boxes": [1, 8], "warmup_steps": 1, "trace_steps": 1},
    "prepare": {"cube": [8, 32, 6, 10], "image_hw": [24, 40], "sample": 4},
}


def tiny_cell(name, tiny_config):
    cell = spec.load_cell(ROOT, name)
    traffic = dict(cell.traffic, **TINY_TRAFFIC[cell.traffic["generator"]])
    if cell.traffic["generator"] == "prepare":
        traffic["frames"] = cell.traffic["frames"][:6]
    config = copy.deepcopy(tiny_config)
    config["model"] = copy.deepcopy(tiny_config["model"])
    if cell.config_name == "kradar_radar":
        model = config["model"]
        model["inputs"] = ["radar_bev", "radar_front"]
        for part in ("skiplinks", "backbones", "necks", "embeddings"):
            model[part].pop("camera_mono")
        for key in ("n_levels", "n_heads", "n_points"):
            model["fuser"][key] = model["fuser"][key][1:]
        model["fuser"]["m_views"] = 2
    return dataclasses.replace(cell, config=config, traffic=traffic)


def drive(cell, seed=2 ** 31 + 11, seconds=0.3, trace=False, patch=None):
    torch.manual_seed(0)
    driver = spec.generator(cell).Driver(cell.config, cell.input_shapes,
                                         cell.traffic, seed, CPU)
    if patch is not None:
        patch(driver)
    lines = []
    result = runner.execute(cell, driver, seconds, trace, CPU,
                            time.perf_counter(), log=lines.append)
    return result, lines


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name,kind", CELL_CASES)
def test_cell_runs_and_is_correct_at_a_tiny_size(name, kind):
    cell = tiny_cell(name, load_tiny(kind))
    result, _ = drive(cell)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in result["metrics"].values():
        assert m["value"] > 0
    assert set(result["checks"]) == set(cell.limits)


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_its_layers(name, tiny_config):
    cell = tiny_cell(name, tiny_config)
    result, _ = drive(cell, trace=True)
    assert result["correct"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in cell.per_layer}
    # The CPU runs no device operation: only host readings come back.
    assert set(result["metrics"]) <= names
    for m in result["metrics"].values():
        assert m["value"] >= 0


def _alter_answer(driver):
    """An answer altered where it is produced: one output element of
    every served frame."""
    inner = driver.serve

    def serve(request):
        out = inner(request)
        out["class"] = out["class"].copy()
        out["class"].flat[0] += 0.5
        return out

    driver.serve = serve


def _unchanged_state(driver):
    """A step that returns its state unchanged: AdamW's update skipped."""
    inner = driver.step

    def step():
        driver.optimizer.step = lambda *args, **kwargs: None
        return inner()

    driver.step = step


def _half_batch(driver):
    """Half of the batch left out, the mean taken over the rest."""
    inner = driver.step

    def step():
        full = driver.batches
        x, t = full[driver.steps_done % len(full)]
        half = ({k: v[: len(v) // 2] for k, v in x.items()},
                {k: v[: len(v) // 2] for k, v in t.items()})
        driver.batches = [half] * len(full)
        try:
            return inner()
        finally:
            driver.batches = full

    driver.step = step


def _one_leaf(driver, move):
    """One leaf's update replaced: ``move(before, after)`` is the value
    the leaf takes after each step."""
    inner = driver.step

    def step():
        leaf = next(iter(driver.names))
        before = leaf.detach().clone()
        out = inner()
        with torch.no_grad():
            leaf.copy_(move(before, leaf.detach()))
        return out

    driver.step = step


def _leaf_unmoved(driver):
    """The update of one leaf left out."""
    _one_leaf(driver, lambda before, after: before)


def _leaf_doubled(driver):
    """The update of one leaf applied twice."""
    _one_leaf(driver, lambda before, after: 2 * after - before)


def _alter_plane(driver):
    """An answer altered where it is produced: one cell of every RA
    plane."""
    setup = driver.setup

    def patched():
        setup()
        inner = driver.processor.get_radar_data

        def altered(filename):
            ra, ea = inner(filename)
            ra = ra.copy()
            ra[0, 0, 0] += 1.0
            return ra, ea

        driver.processor.get_radar_data = altered

    driver.setup = patched


def _swin_attention(driver, fault):
    """Applies ``fault`` to every window attention of the program's Swin
    trunk once set-up is done, so that the window serves with it."""
    setup = driver.setup

    def patched():
        setup()
        found = [m for m in driver.model.modules()
                 if hasattr(m, "relative_position_index")]
        assert found
        for m in found:
            fault(m)

    driver.setup = patched


def _index_zeroed(driver):
    """Swin's relative-position index zeroed in the program: every pair
    of positions reads row 0 of the bias table."""
    _swin_attention(driver, lambda m: m.relative_position_index.zero_())


def _mask_dropped(driver):
    """Swin's shifted-window mask left out in the program: positions that
    the roll brought together attend to each other."""
    def drop(m):
        inner = m._mask
        m._mask = lambda *args: torch.zeros_like(inner(*args))

    _swin_attention(driver, drop)


FAULTS = {
    "serve": [("answer_altered", _alter_answer)],
    "train": [("state_unchanged", _unchanged_state),
              ("half_batch", _half_batch),
              ("leaf_unmoved", _leaf_unmoved),
              ("leaf_doubled", _leaf_doubled)],
    "prepare": [("answer_altered", _alter_plane)],
}
SWIN_FAULTS = {"serve": [("index_zeroed", _index_zeroed),
                         ("mask_dropped", _mask_dropped)]}
FAULT_CASES = (
    [pytest.param(w["name"], f, p, "resnet", id=f"{w['name']}-{f}")
     for w in SPEC["workloads"] for f, p in FAULTS[_generator(w)]]
    + [pytest.param(w["name"], f, p, "swin", id=f"{w['name']}-{f}-swin")
       for w in SPEC["workloads"] if w["name"] in SWIN_CELLS
       for f, p in SWIN_FAULTS.get(_generator(w), [])])


@pytest.mark.parametrize("name,fault,patch,kind", FAULT_CASES)
def test_check_catches_fault(name, fault, patch, kind):
    cell = tiny_cell(name, load_tiny(kind))
    result, lines = drive(cell, patch=patch)
    assert not result["correct"], (fault, result["checks"])


def test_no_jax_module_is_loaded_after_a_run(tmp_path):
    code = f"""
import sys, json, time
sys.path[:0] = [{str(ROOT)!r}, {str(BENCH)!r}, {str(BENCH / 'tests')!r}]
import torch
torch.set_num_threads(2)
import test_h100_bench_cells as t
cfg = json.loads(open({str(BENCH / 'tests' / 'tiny_kradar.json')!r}).read())
result, _ = t.drive(t.tiny_cell("kradar.serve.b1", cfg))
import run
print(json.dumps({{"correct": result["correct"],
                   "forbidden": run.loaded_forbidden()}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last == {"correct": True, "forbidden": []}


def test_forbidden_names_are_compared_whole(monkeypatch):
    import run
    monkeypatch.setitem(sys.modules, "dpft_tpu_torch_probe", object())
    assert "dpft_tpu" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "dpft_tpu.models", object())
    assert "dpft_tpu" in run.loaded_forbidden()


def test_run_refuses_without_a_card(tmp_path):
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "kradar_radar.serve.b1", "--seed", str(2 ** 31 + 3), "--seconds",
         "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode == 2
    assert out.stdout.strip() == ""


def test_run_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run exits non-zero and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload",
         "kradar_radar.serve.b1", "--seed", "5", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
                           "TMPDIR": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
