"""The port's box geometry, IoU and GIoU against the JAX package's.

dpft_tpu_torch/ops/{boxes,iou}.py are held against dpft_tpu/ops/{boxes,
iou}.py on the same numpy boxes, in float32, within 1e-5 (sums and
transcendentals in another order): random overlapping boxes, flush
contact at field-scale distance from the origin, invalid boxes (IoU 0,
GIoU -1) and the reference's GIoU of -1 for disjoint valid boxes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dpft_tpu.ops import boxes as jboxes
from dpft_tpu.ops import iou as jiou
from dpft_tpu_torch.ops import boxes, iou

TOL = dict(rtol=1e-5, atol=1e-5)


def _random_boxes(rng, n, spread=6.0, offset=(0.0, 0.0)):
    center = np.column_stack([rng.uniform(0, spread, n) + offset[0],
                              rng.uniform(0, spread, n) + offset[1],
                              rng.uniform(-1, 1, n)]).astype(np.float32)
    size = rng.uniform(1, 4, (n, 3)).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    return center, size, yaw


def _corners_both(center, size, yaw):
    got = boxes.get_box_corners(torch.from_numpy(center),
                                torch.from_numpy(size), torch.from_numpy(yaw))
    want = jboxes.get_box_corners(jnp.asarray(center)[None],
                                  jnp.asarray(size)[None],
                                  jnp.asarray(yaw)[None])[0]
    return got.numpy(), np.array(want)


def _iou_both(c1, c2):
    got = iou.iou_giou3d(torch.from_numpy(c1), torch.from_numpy(c2))
    want = jax.jit(jiou.iou_giou3d)(jnp.asarray(c1), jnp.asarray(c2))
    return ([g.numpy() for g in got], [np.array(w) for w in want])


@pytest.mark.parametrize("offset", [(0.0, 0.0), (45.0, -30.0)])
def test_boxes_iou_giou_match_jax_on_random_boxes(offset):
    rng = np.random.default_rng(0)
    c1, w1 = _corners_both(*_random_boxes(rng, 24, offset=offset))
    c2, w2 = _corners_both(*_random_boxes(rng, 16, offset=offset))
    np.testing.assert_allclose(c1, w1, **TOL)
    np.testing.assert_allclose(c2, w2, **TOL)

    enc = boxes.get_minimum_enclosing_box_corners(torch.from_numpy(w1),
                                                  torch.from_numpy(w2))
    np.testing.assert_allclose(
        enc.numpy(), np.asarray(jboxes.get_minimum_enclosing_box_corners(
            jnp.asarray(w1), jnp.asarray(w2))), **TOL)
    vol = boxes.get_box_volume_from_corners(torch.from_numpy(w1)).numpy()
    np.testing.assert_allclose(vol, np.asarray(
        jboxes.get_box_volume_from_corners(jnp.asarray(w1))), **TOL)

    (got_iou, got_giou), (want_iou, want_giou) = _iou_both(w1, w2)
    assert got_iou.shape == (24, 16)
    assert 20 < (want_iou > 0).sum() < 24 * 16  # overlapping and disjoint
    np.testing.assert_allclose(got_iou, want_iou, **TOL)
    np.testing.assert_allclose(got_giou, want_giou, **TOL)
    np.testing.assert_allclose(iou.iou3d(torch.from_numpy(w1),
                                         torch.from_numpy(w2)).numpy(),
                               want_iou, **TOL)


def test_batched_pairs_match_per_sample():
    rng = np.random.default_rng(1)
    a = np.stack([_corners_both(*_random_boxes(rng, 9))[1] for _ in range(3)])
    b = np.stack([_corners_both(*_random_boxes(rng, 5))[1] for _ in range(3)])
    got = iou.giou3d(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jiou.giou3d_batched(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, **TOL)


def test_flush_contact_far_from_origin():
    """Half a box, one face flush, 50 m out: IoU 0.5 in both packages."""
    rng = np.random.default_rng(3)
    N = 32
    c = rng.uniform(-50, 50, (N, 2))
    y = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    gt_center = np.column_stack([c, np.zeros(N)]).astype(np.float32)
    pr_center = np.column_stack([c[:, 0] + 0.5 * np.cos(y),
                                 c[:, 1] + 0.5 * np.sin(y),
                                 np.zeros(N)]).astype(np.float32)
    gt = _corners_both(gt_center, np.full((N, 3), 2.0, np.float32), y)[1]
    pr = _corners_both(pr_center, np.tile(np.float32([[1, 2, 2]]), (N, 1)),
                       y)[1]
    got = iou.iou3d(torch.from_numpy(gt)[:, None],
                    torch.from_numpy(pr)[:, None]).numpy()[:, 0, 0]
    want = np.asarray(jiou.iou3d_batched(jnp.asarray(gt)[:, None],
                                         jnp.asarray(pr)[:, None]))[:, 0, 0]
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, 0.5, atol=1e-4)


def test_invalid_and_disjoint_boxes():
    rng = np.random.default_rng(4)
    center, size, yaw = _random_boxes(rng, 6)
    size[0] = 0.0                  # degenerate box
    size[1, 2] = 1e-5              # side faces below the 1e-4 area check
    c1 = _corners_both(center, size, yaw)[1]
    c1 = np.concatenate([c1, np.zeros((1, 8, 3), np.float32)])  # all-zero
    far = _corners_both(center + np.float32([[100, 0, 0]]), size + 1, yaw)[1]
    (got_iou, got_giou), (want_iou, want_giou) = _iou_both(c1, far)
    np.testing.assert_allclose(got_iou, want_iou, **TOL)
    np.testing.assert_allclose(got_giou, want_giou, **TOL)
    np.testing.assert_array_equal(got_iou, 0.0)
    np.testing.assert_array_equal(got_giou, -1.0)  # disjoint or invalid
    (self_iou, self_giou), _ = _iou_both(c1, c1)
    for k in (0, 1, 6):
        assert np.all(self_iou[k] == 0) and np.all(self_giou[k] == -1)
    np.testing.assert_allclose(np.diag(self_iou)[2:6], 1.0, atol=1e-5)
