"""A later change adds a configuration, a traffic mix, a per-layer metric
and a cell as new files and new entries only: the harness finds them by
name, with no edit to a file that is there."""

import hashlib
import json
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, TINY

READER = '''"""Frames inside the profiler window (a test's dummy metric)."""


def read(r):
    return float(r.units * r.frames_per_unit)
'''

DRIVE = '''
import sys, json, time
sys.path[:0] = [{bench!r}, {root!r}]
import torch
torch.set_num_threads(2)
from harness import runner, spec
from pathlib import Path
cell = spec.load_cell(Path({tmp!r}), "tiny.serve.b2")
out = {{}}
for trace in (False, True):
    driver = spec.generator(cell).Driver(cell.config, cell.input_shapes,
                                         cell.traffic, 2 ** 31 + 17,
                                         torch.device("cpu"))
    out[str(trace)] = runner.execute(cell, driver, 0.3, trace,
                                     torch.device("cpu"), time.perf_counter(),
                                     log=lambda line: None)
print(json.dumps(out))
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


@pytest.mark.parametrize("kind", list(TINY))
def test_a_cell_mix_and_metric_added_as_files(tmp_path, kind):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    bench = tmp_path / "h100_bench"
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)

    shutil.copy(BENCH / "tests" / TINY[kind], bench / "configs" / "tiny.json")
    mix = json.loads((BENCH / "traffic" / "serve-b1.json").read_text())
    mix.update(batch=2, pool=2, warmup_calls=2, trace_calls=2, sample=2)
    (bench / "traffic" / "serve-b2.json").write_text(json.dumps(mix))
    (bench / "metrics" / "dummy.frames_traced.serve.py").write_text(READER)
    (bench / "checks" / "tiny.serve.b2.json").write_text(
        json.dumps({"limits": {"serve_out_gap": 1e-3}}))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": "a test",
                            "file": "h100_bench/configs/tiny.json",
                            "reduced": ["model", "data", "computing"],
                            "why": "a test"})
    spec["workloads"].append({"name": "tiny.serve.b2", "config": "tiny",
                              "traffic": "serve-b2", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("tiny.serve.b2")
    spec["per_layer"].append({"name": "dummy.frames_traced.serve",
                              "unit": "frames", "better": "higher",
                              "source": "program_counter", "layer": "device",
                              "moves": "serve_p95_ms",
                              "workloads": ["tiny.serve.b2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    after = _digests(tmp_path)
    changed = [p for p, d in before.items()
               if p.name != "BENCHMARK.json" and after.get(p) != d]
    assert changed == []

    code = DRIVE.format(bench=str(bench), root=str(ROOT), tmp=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    results = json.loads(out.stdout.strip().splitlines()[-1])
    assert results["False"]["correct"] and results["True"]["correct"]
    assert set(results["False"]["metrics"]) == {"serve_p95_ms", "setup_s"}
    assert results["True"]["metrics"]["dummy.frames_traced.serve"][
        "value"] == 4.0
