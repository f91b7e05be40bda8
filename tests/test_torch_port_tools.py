"""The port's copies of the numpy tools (utils/geometry, project, data,
visu; ops/nsga2) against the JAX package's modules, on the same inputs:
the analogs of tests/test_utils_aux.py. The code is the same but for its
imports, so every comparison of arrays is exact; the figures of visu are
held by what they draw."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from dpft_tpu.ops import nsga2 as jax_nsga2  # noqa: E402
from dpft_tpu.utils import data as jax_data  # noqa: E402
from dpft_tpu.utils import geometry as jax_geometry  # noqa: E402
from dpft_tpu.utils import project as jax_project  # noqa: E402
from dpft_tpu_torch.ops import nsga2  # noqa: E402
from dpft_tpu_torch.utils import data, geometry, project, visu  # noqa: E402


def test_geometry_equals_jax():
    for inverse in (False, True):
        t = geometry.get_transformation([1.0, 2.0, 3.0], [0.1, 0.2, 0.3],
                                        inverse=inverse)
        np.testing.assert_array_equal(t, jax_geometry.get_transformation(
            [1.0, 2.0, 3.0], [0.1, 0.2, 0.3], inverse=inverse))
    t = geometry.get_transformation([1.0, 2.0, 3.0], [0.1, 0.2, 0.3])
    t_inv = geometry.get_transformation([1.0, 2.0, 3.0], [0.1, 0.2, 0.3],
                                        inverse=True)
    np.testing.assert_allclose(t @ t_inv, np.eye(4), atol=1e-6)
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(20, 4))
    boxes = np.column_stack([rng.normal(size=(6, 3)), rng.uniform(-3, 3, 6),
                             rng.uniform(1, 4, (6, 3)), rng.normal(size=(6, 2))])
    np.testing.assert_array_equal(geometry.transform_points(pts, t),
                                  jax_geometry.transform_points(pts, t))
    np.testing.assert_array_equal(geometry.transform_boxes(boxes, t),
                                  jax_geometry.transform_boxes(boxes, t))
    np.testing.assert_array_equal(geometry.get_box_corners(boxes[:, :7]),
                                  jax_geometry.get_box_corners(boxes[:, :7]))
    corners = geometry.get_box_corners(np.array([[0, 0, 1.0, 0.0, 2, 2, 2]]))
    assert np.allclose(corners[0, :4, 2], 1.0)
    assert np.allclose(corners[0, 4:, 2], 2.0)


@pytest.mark.parametrize("degrees", [False, True])
def test_project_equals_jax(degrees):
    rng = np.random.default_rng(1)
    a, b, c = rng.uniform(0.5, 40, 9), rng.uniform(-60, 60, 9), \
        rng.uniform(-20, 20, 9)
    for name, args in (("polar2cart", (a, b)), ("cart2polar", (b, c)),
                       ("spher2cart", (a, b, c)), ("cart2spher", (a, b, c))):
        got = getattr(project, name)(*args, degrees=degrees)
        want = getattr(jax_project, name)(*args, degrees=degrees)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=name)
    x, y, z = project.spher2cart(np.array([2.0]), np.array([30.0]),
                                 np.array([10.0]), degrees=True)
    r, phi, roh = project.cart2spher(x, y, z, degrees=True)
    assert abs(r[0] - 2.0) < 1e-6
    assert abs(phi[0] - 30.0) < 1e-4 and abs(roh[0] - 10.0) < 1e-4


def test_collate_equals_jax():
    batch = {"gt_center": np.arange(24.0).reshape(2, 4, 3),
             "gt_mask": np.array([[1, 1, 0, 0], [1, 0, 0, 0]], bool),
             "class": np.arange(20.0).reshape(2, 5, 2)}
    for strip in (False, True):
        got = data.decollate_batch(batch, strip_padding=strip)
        want = jax_data.decollate_batch(batch, strip_padding=strip)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
    rebuilt = data.collate_batch(data.decollate_batch(batch))
    for k, v in jax_data.collate_batch(
            jax_data.decollate_batch(batch)).items():
        np.testing.assert_array_equal(rebuilt[k], v)


def test_visu_draws(tmp_path):
    rng = np.random.default_rng(1)
    np.testing.assert_array_equal(
        visu.scalar2rgba(np.arange(7.0)),
        __import__("dpft_tpu.utils.visu", fromlist=["x"]).scalar2rgba(
            np.arange(7.0)))
    tess = rng.uniform(1e8, 1e10, (4, 8, 3, 5))
    raster = {"d": np.arange(4), "r": np.linspace(1, 10, 8),
              "e": np.linspace(-10, 10, 3), "a": np.linspace(-26, 26, 5)}
    boxes = np.array([[5.0, 0, 0, 0.3, 2, 1, 1, 1, 0]])
    pts = np.column_stack([rng.uniform(1, 9, 50), rng.uniform(-3, 3, 50),
                           rng.uniform(-1, 1, 50), rng.uniform(0, 1, 50)])
    for dims in ("ra", "ea"):
        out = tmp_path / f"grid_{dims}.png"
        visu.visu_radar_tesseract(tess, dims, raster, boxes=boxes,
                                  points=pts, cart=True, dst=str(out))
        assert out.exists()
    fig, axs = plt.subplots(1, 2)
    _, used = visu.visu_radar_tesseract(tess, "ra", raster, ax=axs[0],
                                        show=False)
    assert used is axs[0] and len(axs[0].collections) > 0
    plt.close(fig)
    img = rng.integers(0, 255, (16, 16, 3)).astype(np.uint8)
    visu.visu_camera_data(img, boxes[:, :7], np.eye(4)[:3],
                          dst=str(tmp_path / "cam.png"))
    visu.visu_lidar_data(pts, boxes, dst=str(tmp_path / "lidar.png"))
    assert (tmp_path / "cam.png").exists() and \
        (tmp_path / "lidar.png").exists()


def test_nsga2_equals_jax():
    F = np.array([[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [2.0, 2.0]])
    fronts = nsga2.fast_non_dominated_sort(F)
    assert [list(f) for f in fronts] == \
        [list(f) for f in jax_nsga2.fast_non_dominated_sort(F)]
    np.testing.assert_array_equal(nsga2.crowding_distance(F[fronts[0]]),
                                  jax_nsga2.crowding_distance(F[fronts[0]]))
    rng = np.random.default_rng(0)
    props = rng.integers(0, 2, 30).astype(float)
    target = props.mean()

    def evaluate(x):
        f = []
        for n in range(2):
            sel = props[x == n]
            f.append(abs(sel.mean() - target) if len(sel) else 1.0)
        counts = np.bincount(x, minlength=2)
        return np.array(f), max(0.0, abs(counts[0] - counts[1]) / 30
                                - 1 / 30)

    got = nsga2.nsga2_minimize(evaluate, n_var=30, xl=0, xu=1, pop_size=24,
                               n_gen=20, seed=0)
    want = jax_nsga2.nsga2_minimize(evaluate, n_var=30, xl=0, xu=1,
                                    pop_size=24, n_gen=20, seed=0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
