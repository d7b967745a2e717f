"""Port parity: the scatter-free rotated IoU (dal3d_tpu_torch/ops/
rotated_iou_fast.py) against dal3d_tpu/ops/rotated_iou_fast.py on the same
numpy boxes, f32, within 1e-5 absolute: random boxes, exact duplicates,
coincident edges, contained boxes and zero-size pads; the bitonic network
against JAX's on keys with ties (values and their order); and the physical
bound on duplicates."""
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
