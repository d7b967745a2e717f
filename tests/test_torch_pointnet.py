"""Port parity: the point ops (dal3d_tpu_torch/ops/pointnet.py) against
dal3d_tpu/ops/pointnet.py on the same seeded points in a unit cube, f32 on
the CPU (the port's distances through its plain Gram-form twin of K7). The
tests first assert that the inputs hold no near-tie (sorted neighbour
distances more than 1e-4 apart, no point within 1e-4 of the ball's radius),
so that the indices must equal JAX's: FPS bit for bit, every index equal,
distances and interpolations within 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.ops import pointnet as jp
from dal3d_tpu_torch.ops import pointnet as tp
from test_torch_camera_branch import few_threads  # noqa: F401
from torch_port_utils import t

pytestmark = pytest.mark.usefixtures("few_threads")

TOL = 1e-5
GAP = 1e-4


def _cloud(seed, n=96, m=24):
    rng = np.random.RandomState(seed)
    return (rng.uniform(0, 1, (m, 3)).astype(np.float32),
            rng.uniform(0, 1, (n, 3)).astype(np.float32))


def _exact(q, p):
    return np.sqrt(((q[:, None, :].astype(np.float64) - p[None]) ** 2).sum(-1))


@pytest.mark.parametrize("k", [1, 3, 8])
def test_knn_matches_jax(k):
    q, p = _cloud(1)
    ds = np.sort(_exact(q, p), axis=1)[:, :k + 1]
    assert np.diff(ds, axis=1).min() > GAP  # the k nearest and their order are set
    jd, ji = jp.knn(jnp.asarray(q), jnp.asarray(p), k)
    td, ti = tp.knn(t(q), t(p), k)
    assert ti.dtype == torch.int64 and ti.shape == (len(q), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=TOL)


def test_three_nn_and_interpolate_match_jax():
    q, p = _cloud(1, n=64, m=40)
    ds = np.sort(_exact(q, p), axis=1)[:, :4]
    assert np.diff(ds, axis=1).min() > GAP
    feats = np.random.RandomState(2).normal(0, 1, (len(p), 16)).astype(np.float32)
    jd, ji = jp.three_nn(jnp.asarray(q), jnp.asarray(p))
    td, ti = tp.three_nn(t(q), t(p))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=TOL)
    # the interpolation on JAX's neighbours and distances: near a point the
    # weights magnify the distances' Gram rounding (held above) tenfold
    want = np.asarray(jp.three_interpolate(jnp.asarray(feats), ji, jd))
    got = tp.three_interpolate(t(feats), t(ji).long(), t(jd))
    assert got.shape == (len(q), 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("nsample", [4, 16])
def test_ball_query_matches_jax(nsample):
    q, p = _cloud(0, n=80, m=20)
    q[0] = [5.0, 5.0, 5.0]  # no point within the radius
    q[1] = p[7] + np.float32(0.001)  # a short group: a few points near it
    radius = 0.25
    d = _exact(q, p)
    assert np.abs(d - radius).min() > GAP
    hits = (d <= radius).sum(1)
    assert hits[0] == 0 and 0 < hits.min(initial=99, where=hits > 0) < nsample
    ji, jhas = jp.ball_query(jnp.asarray(q), jnp.asarray(p), radius, nsample)
    ti, thas = tp.ball_query(t(q), t(p), radius, nsample)
    assert ti.dtype == torch.int64 and ti.shape == (len(q), nsample)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(thas.numpy(), np.asarray(jhas))
    assert not bool(thas[0]) and (ti[0] == 0).all()
    short = int(np.argmin(np.where(hits > 0, hits, 99)))
    row = ti[short].numpy()
    assert (row[hits[short]:] == row[0]).all()  # a short group repeats its first hit


def test_gather_and_group_points_match_jax():
    _, p = _cloud(4)
    feats = np.random.RandomState(5).normal(0, 1, (len(p), 7)).astype(np.float32)
    rng = np.random.RandomState(6)
    idx, grp = rng.randint(0, len(p), 11), rng.randint(0, len(p), (11, 5))
    np.testing.assert_array_equal(tp.gather_points(t(feats), t(idx)).numpy(),
                                  np.asarray(jp.gather_points(jnp.asarray(feats), idx)))
    got = tp.group_points(t(feats), t(grp))
    assert got.shape == (11, 5, 7)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jp.group_points(jnp.asarray(feats), grp)))


def test_furthest_point_sample_is_bit_equal_to_jax():
    _, p = _cloud(7, n=300)
    p[10] = p[3]  # a duplicate point
    want = np.asarray(jp.furthest_point_sample(jnp.asarray(p), 64))
    got = tp.furthest_point_sample(t(p), 64)
    assert got.dtype == torch.int64 and got[0] == 0
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(got.tolist())) == 64
