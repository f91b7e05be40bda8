"""The port's own copies of the numpy host modules against their originals.

The port imports nothing of the JAX package, so it keeps copies of the data
layer (dataset, loader, PCD reader, split tables, radar constants), the
JSON config helpers, the K-Radar exporter and the LAP binding. Each copy is
held here against the module it was copied from, on the same inputs; every
comparison is exact, because the code is the same.
"""

import os
import os.path as osp

import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

import dpft_tpu.data as jax_data
import dpft_tpu.data.pcd as jax_pcd
import dpft_tpu.utils.config as jax_config
import dpft_tpu_torch.data as port_data
import dpft_tpu_torch.data.pcd as port_pcd
import dpft_tpu_torch.utils.config as port_config
from dpft_tpu.data.kradar import radar_info as jax_radar_info
from dpft_tpu.data.kradar import splits as jax_splits
from dpft_tpu.evaluation import exporters as jax_exporters
from dpft_tpu.ops import lap_native as jax_lap
from dpft_tpu_torch.data.kradar import radar_info as port_radar_info
from dpft_tpu_torch.data.kradar import splits as port_splits
from dpft_tpu_torch.evaluation import exporters as port_exporters
from dpft_tpu_torch.ops import lap_native as port_lap
from dpft_tpu_torch.utils.example import example_batch, example_targets
from kradar_fixture import base_config, make_raw_kradar
from torch_port_common import assert_trees_equal

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    """The fixture tree, prepared by the port's ETL on its NumPy path."""
    root = str(tmp_path_factory.mktemp("port_data"))
    config = base_config()
    config["data"]["use_device"] = False
    dst = osp.join(root, "processed")
    port_data.prepare("kradar", config).prepare(make_raw_kradar(root), dst)
    return dst, base_config()


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_dataset_samples_equal(processed, split):
    dst, config = processed
    got = port_data.init("kradar", src=dst, split=split, config=config)
    want = jax_data.init("kradar", src=dst, split=split, config=config)
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        (g_in, g_tgt), (w_in, w_tgt) = got[i], want[i]
        assert_trees_equal(g_in, w_in, f"{split}[{i}] inputs")
        assert_trees_equal(g_tgt, w_tgt, f"{split}[{i}] targets")


def test_dataset_modality_dropout_draws_equal(processed):
    dst, config = processed
    config["data"]["dropout"] = [0.2, 0.4, 0.4]
    got = port_data.init("kradar", src=dst, split="train", config=config)
    want = jax_data.init("kradar", src=dst, split="train", config=config)
    for seed in range(4):
        np.random.seed(seed)
        g_in, _ = got[0]
        np.random.seed(seed)
        w_in, _ = want[0]
        assert_trees_equal(g_in, w_in, f"seed {seed}")


@pytest.mark.parametrize("kwargs", [
    dict(shuffle=True),
    dict(shuffle=True, drop_last=True),
    dict(shuffle=False, pad_last=True),
    dict(shuffle=True, pad_last=False),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize("batch_size,workers", [(1, 0), (2, 2), (3, 0)])
def test_loader_batches_equal(processed, kwargs, batch_size, workers):
    dst, config = processed
    config["train"]["batch_size"] = batch_size
    config["computing"]["workers"] = workers
    got_ds = port_data.init("kradar", src=dst, split="train", config=config)
    want_ds = jax_data.init("kradar", src=dst, split="train", config=config)
    got = port_data.load(got_ds, config, **kwargs)
    want = jax_data.load(want_ds, config, **kwargs)
    assert len(got) == len(want)
    for epoch in range(2):  # the shuffle order depends on (seed, epoch)
        got_batches, want_batches = list(got), list(want)
        assert len(got_batches) == len(want_batches) == len(want)
        for (g_in, g_tgt), (w_in, w_tgt) in zip(got_batches, want_batches):
            assert_trees_equal(g_in, w_in, f"epoch {epoch} inputs")
            assert_trees_equal(g_tgt, w_tgt, f"epoch {epoch} targets")


def test_loader_subset_and_real_mask_equal():
    class Items:
        def __len__(self):
            return 5

        def __getitem__(self, i):
            return ({"x": np.full(2, i)}, {"y": np.full(1, i)})

    batches = []
    for loader_lib in (port_data.loader, jax_data.loader):
        subset = loader_lib.Subset(Items(), [4, 0, 2],
                                   real=[True, True, False])
        loader = loader_lib.DataLoader(subset, batch_size=2, pad_last=True)
        batches.append(list(loader))
    for (g_in, g_tgt), (w_in, w_tgt) in zip(*batches):
        assert_trees_equal(g_in, w_in)
        assert_trees_equal(g_tgt, w_tgt)
    np.testing.assert_array_equal(batches[0][1][1]["sample_mask"],
                                  [False, False])


def test_split_tables_and_radar_constants_equal():
    for name in ("train", "val", "test", "trainval", "full"):
        assert port_splits.get_split(name) == jax_splits.get_split(name)
    assert len(port_splits.get_split("train")) == 13967
    with pytest.raises(ValueError):
        port_splits.get_split("nope")
    for name in ("azimuth_raster", "elevation_raster", "range_raster",
                 "doppler_raster", "max_power", "min_power"):
        np.testing.assert_array_equal(getattr(port_radar_info, name),
                                      getattr(jax_radar_info, name))


@pytest.mark.parametrize("mode", ["ascii", "binary"])
def test_pcd_round_trip_equal(tmp_path, rng, mode):
    fields = {
        "x": rng.normal(size=10).astype(np.float32),
        "t": rng.integers(0, 1_000_000, 10).astype(np.uint32),
        "ring": rng.integers(0, 128, 10).astype(np.uint8),
    }
    paths = [str(tmp_path / "port.pcd"), str(tmp_path / "jax.pcd")]
    port_pcd.write_pcd(paths[0], fields, mode=mode)
    jax_pcd.write_pcd(paths[1], fields, mode=mode)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    got, want = port_pcd.read_pcd(paths[1]), jax_pcd.read_pcd(paths[0])
    assert_trees_equal(got, want)
    for name, values in fields.items():
        np.testing.assert_array_equal(got[name], values)


def test_config_load_save_equal(tmp_path):
    config = base_config()
    paths = [str(tmp_path / "a" / "port.json"), str(tmp_path / "b" / "jax.json")]
    port_config.save_config(config, paths[0])
    jax_config.save_config(config, paths[1])
    with open(paths[0]) as a, open(paths[1]) as b:
        text = a.read()
        assert text == b.read()
    assert port_config.load_config(paths[1]) == config
    assert port_config.loads_config(text) == jax_config.loads_config(text)
    flagship = osp.join(ROOT, "config", "kradar.json")
    assert port_config.load_config(flagship) == \
        jax_config.load_config(flagship)


def test_exporter_txt_tree_equal(tmp_path, rng):
    config = base_config()
    B, N = 2, 6
    M = config["data"]["max_boxes"]
    angle = rng.uniform(-np.pi, np.pi, (B, N))
    outputs = {
        "class": rng.uniform(size=(B, N, 2)).astype(np.float32),
        "center": rng.uniform([0, -8, -3], [80, 8, 7],
                              size=(B, N, 3)).astype(np.float32),
        "size": rng.uniform(1, 5, size=(B, N, 3)).astype(np.float32),
        "angle": np.stack([np.sin(angle), np.cos(angle)],
                          -1).astype(np.float32),
    }
    targets = example_targets(config, B=B, seed=5)
    targets["gt_center"][..., 1] = rng.uniform(-6, 6, (B, M))
    targets["gt_center"][..., 2] = rng.uniform(-2, 6, (B, M))
    targets["description"] = np.array([[1, 0, 3], [0, 1, 0]], np.float32)
    targets["sample_mask"] = np.array([True, True])
    trees = []
    for lib, name in ((port_exporters, "port"), (jax_exporters, "jax")):
        exporter = lib.build("kradar", config)
        dst = str(tmp_path / name)
        for step in (0, 1):
            exporter.export(outputs, targets, step=step, dst=dst)
        files = {}
        for d, _, names in os.walk(dst):
            for n in names:
                with open(osp.join(d, n)) as f:
                    files[osp.relpath(osp.join(d, n), dst)] = f.read()
        trees.append(files)
    assert trees[0] == trees[1]
    assert any(k.endswith(osp.join("all", "preds", "000000.txt"))
               for k in trees[0])
    assert any(text.strip() for text in trees[0].values())
    with pytest.raises(ValueError):
        port_exporters.build("nuscenes", config)


def test_lap_binding_matches_original_and_scipy(rng):
    for _ in range(20):
        R = int(rng.integers(1, 12))
        C = int(rng.integers(R, 40))
        cost = rng.normal(size=(R, C)) * 10
        got = port_lap.solve(cost)
        np.testing.assert_array_equal(got, jax_lap.solve(cost))
        rows, cols = linear_sum_assignment(cost)
        assert abs(cost[np.arange(R), got].sum()
                   - cost[rows, cols].sum()) < 1e-9
    costs = rng.normal(size=(5, 6, 20))
    np.testing.assert_array_equal(port_lap.solve_batch(costs),
                                  jax_lap.solve_batch(costs))
    with pytest.raises(ValueError):
        port_lap.solve(np.zeros((5, 3)))  # more rows than columns


def test_lap_library_is_built_under_build_kernels():
    port_lap.load_library()
    built = os.listdir(osp.join(ROOT, "build", "kernels"))
    assert any(n.startswith("liblap_") and n.endswith(".so") for n in built)


def test_example_batches_equal_the_originals():
    from __graft_entry__ import _example_batch, _example_targets

    config = port_config.load_config(osp.join(ROOT, "config", "kradar.json"))
    assert_trees_equal(example_batch(config, B=2, cam_hw=(32, 40), seed=3),
                       _example_batch(config, B=2, cam_hw=(32, 40), seed=3))
    assert_trees_equal(example_targets(config, B=2, seed=4),
                       _example_targets(config, B=2, seed=4))


@pytest.mark.parametrize("copy,original", [
    ("dpft_tpu_torch/csrc/radar_reduce_host.cc", "native/radar_reduce.cc"),
    ("dpft_tpu_torch/utils/geometry.py", "dpft_tpu/utils/geometry.py"),
    ("dpft_tpu_torch/utils/project.py", "dpft_tpu/utils/project.py"),
    ("dpft_tpu_torch/utils/data.py", "dpft_tpu/utils/data.py"),
    ("dpft_tpu_torch/utils/visu.py", "dpft_tpu/utils/visu.py"),
    ("dpft_tpu_torch/ops/nsga2.py", "dpft_tpu/ops/nsga2.py"),
])
def test_copy_has_not_drifted(copy, original):
    """Copies whose text is the original's but for the package name in
    their imports."""
    with open(osp.join(ROOT, copy)) as f:
        got = f.read()
    with open(osp.join(ROOT, original)) as f:
        want = f.read()
    assert got.replace("dpft_tpu_torch.", "dpft_tpu.") == want
