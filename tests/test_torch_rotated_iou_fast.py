"""Port parity: the scatter-free rotated IoU (dal3d_tpu_torch/ops/
rotated_iou_fast.py) against dal3d_tpu/ops/rotated_iou_fast.py on the same
numpy boxes, f32, within 1e-5 absolute: random boxes, exact duplicates,
coincident edges, contained boxes and zero-size pads; the bitonic network
against JAX's on keys with ties (values and their order); and the physical
bound on duplicates. The Green's-theorem engine (``rotated_iou_matrix_greens``
and its pair form) on the same boxes, and ``ops/nms.py::rotate_nms``
against JAX's through both its IoU routes (K2's plain twin and the Green's
matrix) on boxes with no IoU within 1e-4 of the threshold."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.ops import rotated_iou_fast as jf
from dal3d_tpu_torch.ops import rotated_iou_fast as tf
from torch_port_utils import t

TOL = 1e-5
# jitted once per module: a jax.jit made in each test compiles again
JAX_IOU3D = jax.jit(jf.boxes_iou3d_fast)
JAX_BEV = jax.jit(jf.rotated_iou_matrix_fast)
JAX_GREENS = jax.jit(jf.rotated_iou_matrix_greens)


def _boxes(seed, n=48):
    """[n, 9] boxes (x, y, z, w, l, h, vx, vy, yaw): random ones, then
    duplicates, coincident-edge, contained and zero-size rows."""
    rng = np.random.RandomState(seed)
    b = np.zeros((n, 9), np.float32)
    b[:, :2] = rng.uniform(-4, 4, (n, 2))
    b[:, 2] = rng.uniform(-2, 0, n)
    b[:, 3:6] = rng.uniform(0.3, 5.0, (n, 3))
    b[:, 8] = rng.uniform(-np.pi, np.pi, n)
    b[30:34] = b[0:4]  # exact duplicates
    b[34] = [0, 0, 0, 1, 1, 1, 0, 0, 0]
    b[35] = [1, 0, 0, 1, 1, 1, 0, 0, 0]  # shares an edge with 34
    b[36] = [0.5, 0, 0, 1, 1, 1, 0, 0, 0]  # half over 34, coincident top / bottom
    b[37] = [0, 0, 0.25, 0.5, 0.5, 0.5, 0, 0, 0]  # inside 34
    b[38] = [0, 0, 0, 1, 1, 1, 0, 0, np.pi / 2]  # 34 turned a quarter: same square
    b[39] = [0, 0, 0, 2, 4, 1, 0, 0, np.pi / 4]  # contains 34 rotated
    b[40:42] = 0  # zero-size pads at the origin
    b[42] = [0, 0, 0, 0, 0, 1, 0, 0, 0]
    return b


@pytest.mark.parametrize("seed", [0, 1])
def test_boxes_iou3d_fast_matches_jax(seed):
    a, b = _boxes(seed), _boxes(seed + 10)  # one shape: one JAX compile
    b[:6] = a[:6]
    for x, y in ((a, a), (a, b)):
        want = np.asarray(JAX_IOU3D(jnp.asarray(x), jnp.asarray(y)))
        got = tf.boxes_iou3d_fast(t(x), t(y)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    iou = tf.boxes_iou3d_fast(t(a), t(a)).numpy()
    np.testing.assert_allclose(np.diag(iou[30:34, 0:4]), 1.0, atol=TOL)  # duplicates
    assert iou[34, 35] == pytest.approx(0.0, abs=TOL)
    assert iou[34, 36] == pytest.approx(1 / 3, abs=TOL)
    assert iou[34, 37] == pytest.approx(0.125, abs=TOL)
    assert iou[34, 38] == pytest.approx(1.0, abs=TOL)
    assert np.all(iou[40:43] == 0) and np.all(iou[:, 40:43] == 0)
    assert iou.max() <= 1.0 + TOL  # the physical bound holds on every pair


@pytest.mark.parametrize("seed", [0, 1])
def test_rotated_iou_matrix_fast_matches_jax(seed):
    a = _boxes(seed)[:, [0, 1, 3, 4, 8]]
    b = _boxes(seed + 20)[:, [0, 1, 3, 4, 8]]
    for x, y in ((a, a), (a, b)):
        want = np.asarray(JAX_BEV(jnp.asarray(x), jnp.asarray(y)))
        got = tf.rotated_iou_matrix_fast(t(x), t(y)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_bitonic_network_matches_jax_on_ties():
    """Equal keys (and the 1e9 pads) end where JAX's network puts them:
    values and their carried points are equal, not only the sorted keys."""
    rng = np.random.RandomState(3)
    keys = rng.randint(0, 5, (64, 32)).astype(np.float32)
    keys[:, 24:] = 1e9
    vals = rng.randn(64, 32, 2).astype(np.float32)
    jk, jv = jax.jit(jf._bitonic_sort_by_key)(jnp.asarray(keys), jnp.asarray(vals))
    tk, tv = tf._bitonic_sort_by_key(t(keys), t(vals))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert np.all(np.diff(tk.numpy(), axis=1) >= 0)


def test_intersection_helpers_match_jax():
    """The candidate sets the area is built from: corners inside the other
    quad and the 16 edge intersections with their masks (the area itself is
    held through the two IoU functions above)."""
    from dal3d_tpu.core.box_ops_jax import corners_2d as jax_corners
    from dal3d_tpu_torch.core.box_ops import corners_2d

    bev = _boxes(5)[:, [0, 1, 3, 4, 8]]
    c = corners_2d(t(bev))
    np.testing.assert_allclose(c.numpy(), np.asarray(jax_corners(jnp.asarray(bev))),
                               atol=1e-6)
    c1, c2 = c[:, None], c[None, :]
    jc = jnp.asarray(c.numpy())
    jp, jv = jf._edge_intersections(*jnp.broadcast_arrays(jc[:, None], jc[None, :]))
    tp, tv = tf._edge_intersections(*torch.broadcast_tensors(c1, c2))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tp.numpy()[tv.numpy()], np.asarray(jp)[np.asarray(jv)],
                               atol=1e-5)
    np.testing.assert_array_equal(
        tf._point_in_quad(c[:, 0], c[0]).numpy(),
        np.asarray(jf._point_in_quad(jc[:, 0], jc[0])))


@pytest.mark.parametrize("seed", [0, 1])
def test_greens_matrix_matches_jax(seed):
    """Random boxes, duplicates, a shared edge, half overlaps with
    coincident edges, a quarter turn of a square and zero-size pads."""
    a = _boxes(seed)[:, [0, 1, 3, 4, 8]]
    b = _boxes(seed + 20)[:, [0, 1, 3, 4, 8]]
    b[:6] = a[:6]
    for x, y in ((a, a), (a, b)):
        want = np.asarray(JAX_GREENS(jnp.asarray(x), jnp.asarray(y)))
        got = tf.rotated_iou_matrix_greens(t(x), t(y)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    iou = tf.rotated_iou_matrix_greens(t(a), t(a)).numpy()
    np.testing.assert_allclose(np.diag(iou[30:34, 0:4]), 1.0, atol=TOL)  # duplicates
    assert iou[34, 35] == pytest.approx(0.0, abs=TOL)  # touching edges
    assert iou[34, 36] == pytest.approx(1 / 3, abs=TOL)
    assert iou[34, 37] == pytest.approx(0.25, abs=TOL)  # a quarter-area square inside
    assert iou[34, 38] == pytest.approx(1.0, abs=TOL)  # turned 90 degrees
    assert np.all(iou[40:43] == 0) and np.all(iou[:, 40:43] == 0)
    assert iou.max() <= 1.0 + TOL
    # against the sorting engine on the same pairs
    np.testing.assert_allclose(iou, tf.rotated_iou_matrix_fast(t(a), t(a)).numpy(), atol=1e-4)


def test_greens_pair_area_matches_jax():
    from dal3d_tpu.core.box_ops_jax import corners_2d as jax_corners
    from dal3d_tpu_torch.core.box_ops import corners_2d

    bev = _boxes(6)[:, [0, 1, 3, 4, 8]]
    jc = jax_corners(jnp.asarray(bev))
    want = np.asarray(jax.jit(jf._pair_intersection_area_greens)(jc[:, None], jc[None, :]))
    c = corners_2d(t(bev))
    got = tf._pair_intersection_area_greens(c[:, None], c[None, :]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    n, an = tf._clip_planes(c)
    jn, jan = jf._clip_planes(jc)
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), atol=1e-6)
    np.testing.assert_allclose(an.numpy(), np.asarray(jan), atol=1e-5)


def _nms_inputs(seed, n=160):
    """Clusters of overlapping boxes (lidar-scale BEV x, y, w, l, yaw), ties
    in the scores, invalid rows; no IoU within 1e-4 of the 0.2 threshold."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(-20, 20, (24, 2))
    b = np.zeros((n, 5), np.float32)
    b[:, :2] = centres[rng.randint(0, 24, n)] + rng.normal(0, 0.6, (n, 2))
    b[:, 2:4] = rng.uniform(1.0, 4.5, (n, 2))
    b[:, 4] = rng.uniform(-np.pi, np.pi, n)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[10:20] = scores[0]  # ties: the lower index first
    valid = rng.uniform(0, 1, n) > 0.1
    return b, scores, valid


def _greens_batched(boxes1, boxes2):
    """``iou_matrix.rotated_iou_matrix_batched``'s signature on the Green's
    matrix ([1, N, 5] x [1, M, 5] -> [1, N, M]): JAX's route in ``rotate_nms``."""
    return tf.rotated_iou_matrix_greens(boxes1[0], boxes2[0])[None]


@pytest.mark.parametrize("seed", [0, 2])
def test_rotate_nms_matches_jax_on_both_routes(seed, monkeypatch):
    from dal3d_tpu.ops.nms import rotate_nms as jax_rotate_nms
    from dal3d_tpu_torch.ops import nms
    from dal3d_tpu_torch.ops.nms import rotate_nms

    b, s, v = _nms_inputs(seed)
    greens = np.asarray(JAX_GREENS(jnp.asarray(b), jnp.asarray(b)))
    assert np.abs(greens - 0.2).min() > 1e-4
    ji, jk = jax_rotate_nms(jnp.asarray(b), jnp.asarray(s), jnp.asarray(v),
                            pre_max_size=128, post_max_size=83)
    for route in ("K2's twin", "Green's"):
        if route == "Green's":
            monkeypatch.setattr(nms.iou_matrix, "rotated_iou_matrix_batched", _greens_batched)
        ti, tk = rotate_nms(t(b), t(s), t(v), pre_max_size=128, post_max_size=83)
        assert ti.shape == (83,) and tk.dtype == torch.bool
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert 0 < int(tk.sum()) < min(int(v.sum()), 128) - 10  # boxes suppressed, slots empty


def test_greens_and_rotate_nms_against_jax_on_predict_candidates(monkeypatch):
    """Two candidate sets of a full-width predict (the head's 1000 best
    boxes of a task and frame, in its rank order, from ``chip_smoke.py``
    phase 3's seeded weights and cloud on an H100:
    ``tests/fixtures/predict_candidates.npz``): near-coincident boxes, and
    in the first set 44 boxes over a km long (the untrained weights' size
    deltas). The Green's matrix jumps where an edge crosses the 1e-4 m
    band, and the port's corners (rounded once from f64) and JAX's (XLA's
    f32 sin and cos) differ in the last bit, so the two matrices differ on
    such pairs: on the boxes under a km by at most 2.7e-2, on 0.2-1.9 % of
    the pairs past 1e-5; on the km-long boxes by up to 2/3
    (``test_torch_iou.py::test_self_iou_of_km_long_predict_candidates``).
    ``rotate_nms`` keeps JAX's indices through both its routes on both
    sets."""
    from dal3d_tpu.ops.nms import rotate_nms as jax_rotate_nms
    from dal3d_tpu_torch.ops import nms
    from dal3d_tpu_torch.ops.nms import rotate_nms

    sets = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                                "predict_candidates.npz"))["bev"]
    scores = np.arange(sets.shape[1], 0, -1).astype(np.float32)  # the head's rank
    valid = np.ones(sets.shape[1], bool)
    for b in sets:
        short = np.abs(b[:, 2:4]).max(1) < 1000.0
        gap = np.abs(tf.rotated_iou_matrix_greens(t(b), t(b)).numpy()
                     - np.asarray(JAX_GREENS(jnp.asarray(b), jnp.asarray(b))))
        gap = gap[short][:, short]
        assert gap.max() <= 3e-2 and (gap > 1e-5).mean() <= 0.02
        ji, jk = jax_rotate_nms(jnp.asarray(b), jnp.asarray(scores), jnp.asarray(valid))
        with monkeypatch.context() as m:
            for route in ("K2's twin", "Green's"):
                if route == "Green's":
                    m.setattr(nms.iou_matrix, "rotated_iou_matrix_batched", _greens_batched)
                ti, tk = rotate_nms(t(b), t(scores), t(valid))
                np.testing.assert_array_equal(ti.numpy(), np.asarray(ji), err_msg=route)
                np.testing.assert_array_equal(tk.numpy(), np.asarray(jk), err_msg=route)
