"""Import guard: the PyTorch port never imports JAX, flax or the JAX package.

A fresh interpreter imports dpft_tpu_torch and every module under it,
builds a tiny model on the CPU and runs it; neither ``jax`` nor ``flax``,
nor ``dpft_tpu`` or any module under it, nor ``__graft_entry__`` may then
be in ``sys.modules``. The port keeps its own copies of the numpy host
modules it needs (config, data, the K-Radar exporter, the LAP binding).
The source scan covers ``chip_smoke.py`` too.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = {
    "computing": {"seed": 0, "device": "cpu"},
    "model": {
        "name": "dprt",
        "inputs": ["camera_mono", "radar_bev"],
        "skiplinks": {"camera_mono": True, "radar_bev": True},
        "backbones": {
            "camera_mono": {"name": "ResNet18", "multi_scale": 2},
            "radar_bev": {"name": "ResNet18", "in_channels": 6,
                          "multi_scale": 2}},
        "necks": {
            "camera_mono": {"name": "FPN", "in_channels_list": [3, 64, 128],
                            "out_channels": 8},
            "radar_bev": {"name": "FPN", "in_channels_list": [6, 64, 128],
                          "out_channels": 8}},
        "embeddings": {k: {"name": "sinusoidal_embedding", "num_feats": 8,
                           "normalize": True}
                       for k in ("camera_mono", "radar_bev")},
        "querent": {"name": "data_agnostic_static_querent",
                    "transformation": "spher2cart", "resolution": [2, 2, 1],
                    "minimum": [4, -50, 0], "maximum": [72, 50, 0]},
        "fuser": {"name": "IMPFusion", "i_iter": 1, "m_views": 2,
                  "d_model": 8, "d_ffn": 16, "n_queries": 4,
                  "n_levels": [3, 3], "n_heads": [2, 2], "n_points": [2, 2],
                  "norm": True, "reduction": "linear", "activation": "Mish"},
        "head": {"name": "linear_detection_head", "in_channels": 8,
                 "num_classes": 2},
    },
}

SCRIPT = """
import importlib, json, pkgutil, sys
import numpy as np, torch
import dpft_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dpft_tpu_torch.__path__,
                                                "dpft_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from dpft_tpu_torch.models import build
config = json.loads(sys.argv[1])
model = build("dprt", config, device="cpu")
rng = np.random.default_rng(0)
batch = {}
for name, (h, w, c) in (("camera_mono", (24, 32, 3)), ("radar_bev", (16, 8, 6))):
    batch[name] = rng.normal(size=(1, h, w, c))
    batch[name + "_shape"] = np.array([[h, w, c]])
    batch["label_to_%s_t" % name] = np.eye(4)[None]
    batch["label_to_%s_p" % name] = rng.normal(size=(1, 3, 4))
with torch.inference_mode():
    out = model({k: torch.tensor(v, dtype=torch.float32)
                 for k, v in batch.items()})
assert out["class"].shape == (1, 4, 2), out["class"].shape
print(json.dumps({"modules": names, "leaked": sorted(
    m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "dpft_tpu", "__graft_entry__"))}))
"""


def test_port_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(TINY)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "dpft_tpu_torch.ops.deform_attn" in report["modules"]
    assert "dpft_tpu_torch.evaluate" in report["modules"]
    for name in ("train", "training.trainer", "training.loss",
                 "training.assigner", "training.optimizer",
                 "training.scheduler", "evaluation.metric", "ops.boxes",
                 "ops.iou", "ops.hungarian", "prepare",
                 "data.kradar.processor", "ops.radar_reduce", "data.loader",
                 "utils.config", "utils.device"):
        assert f"dpft_tpu_torch.{name}" in report["modules"], name
    assert report["leaked"] == []


FORBIDDEN = ("jax", "flax", "dpft_tpu", "__graft_entry__")


def _offending_imports(path):
    """Lines of ``path`` that import a forbidden top-level module."""
    offenders = []
    with open(path) as f:
        for line in f:
            words = line.replace(",", " ").split()
            if words[:1] == ["from"] and len(words) > 1:
                names = words[1:2]
            elif words[:1] == ["import"]:
                names = [w for w in words[1:] if w != "as"]
            else:
                continue
            if any(n.split(".")[0] in FORBIDDEN for n in names):
                offenders.append(f"{os.path.basename(path)}: {line.strip()}")
    return offenders


def test_port_sources_name_no_jax():
    """No file of the port, nor chip_smoke.py, imports jax, flax, the JAX
    package or its ``__graft_entry__`` module, even lazily."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "dpft_tpu_torch")):
        paths += [os.path.join(d, n) for n in files if n.endswith(".py")]
    assert len(paths) > 40
    offenders = [line for path in paths for line in _offending_imports(path)]
    assert offenders == []


def test_source_scan_catches_each_form(tmp_path):
    path = tmp_path / "sample.py"
    path.write_text(
        "import numpy as np\n"
        "from dpft_tpu_torch.ops import kernels\n"
        "import dpft_tpu_torch.data\n"
        "from dpft_tpu.data import init\n"
        "    from dpft_tpu import utils\n"
        "import dpft_tpu.ops.lap_native as lap\n"
        "import os, dpft_tpu\n"
        "    from __graft_entry__ import _example_batch\n"
        "import jax.numpy as jnp\n"
        "from flax import linen\n")
    assert len(_offending_imports(str(path))) == 7
