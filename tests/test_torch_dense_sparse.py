"""Port parity of the dense-compute sparse-semantics ops
(dal3d_tpu_torch/ops/dense_sparse.py, the hybrid and dense engines) against
``dal3d_tpu/ops/dense_sparse.py`` on the CPU, at the small voxels' grid
(41, 64, 64), B=2, and the strided grids of the backbone's downsamples.

Required: ``to_dense_grid`` and ``dilate_occupancy`` bit-equal (JAX's 27
shifted-slice maxima against ``F.max_pool3d``); ``subm_conv_dense`` and
``sparse_conv_down_dense`` within 1e-5 of scale in f32 (summation order) and
within 2e-2 in bf16 (JAX rounds every depth slice's partial sum to bf16,
the port rounds once); ``masked_mean_var`` within 1e-6 of scale; inactive
cells exactly zero."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.ops import dense_sparse as jds
from dal3d_tpu.ops import sparse_grid as jsg
from dal3d_tpu_torch.ops import dense_sparse as ds
from dal3d_tpu_torch.ops import sparse_grid as spg
from test_torch_camera_branch import few_threads  # noqa: F401
from torch_port_utils import small_voxels, t

pytestmark = pytest.mark.usefixtures("few_threads")

SHAPE = (41, 64, 64)
# the backbone's convs: (kernel, stride, padding, Cin, Cout); stride 1 = SubM
CONVS = [((3, 3, 3), (1, 1, 1), None, 5, 16), ((3, 3, 3), (2, 2, 2), (1, 1, 1), 16, 32),
         ((3, 3, 3), (2, 2, 2), (0, 1, 1), 64, 128), ((3, 1, 1), (2, 1, 1), (0, 0, 0), 128, 128)]


def _grid(C, seed):
    """Both packages' (dense, occ) of the small voxels with C random
    channels."""
    vf, vc, vv = small_voxels(seed)
    feats = np.random.RandomState(seed).randn(*vf.shape[:2], C).astype(np.float32)
    jd, jo = jds.to_dense_grid(jsg.from_voxels(jnp.asarray(feats), jnp.asarray(vc),
                                               jnp.asarray(vv), SHAPE))
    td, to = ds.to_dense_grid(spg.from_voxels(t(feats), t(vc), t(vv), SHAPE))
    return (np.array(jd), np.array(jo)), (td, to)


def test_to_dense_grid_and_dilation_bit_equal():
    (jd, jo), (td, to) = _grid(5, 0)
    assert td.shape == (2, *SHAPE, 5) and to.shape == (2, *SHAPE)
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_array_equal(to.numpy(), jo)
    for k, s, p, _, _ in CONVS[1:]:
        want = np.array(jds.dilate_occupancy(jnp.asarray(jo), k, s, p))
        got = ds.dilate_occupancy(to, k, s, p)
        assert got.dtype == to.dtype
        np.testing.assert_array_equal(got.numpy(), want)
        assert 0 < want.sum() < want.size


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_convs_match_jax(dtype, tol):
    rng = np.random.RandomState(1)
    (jd, jo), (td, to) = _grid(5, 1)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    for k, s, p, cin, cout in CONVS:
        K = int(np.prod(k))
        # the deeper convs on a dilated occupancy with random features, as
        # they meet it after the downsamples
        occ = jo if p is None else np.array(jds.dilate_occupancy(jnp.asarray(jo), k, (1, 1, 1),
                                                                 tuple(x // 2 for x in k)))
        x = (rng.randn(*jo.shape, cin) * occ[..., None]).astype(np.float32)
        w = (rng.randn(K, cin, cout) / np.sqrt(K * cin)).astype(np.float32)
        if p is None:
            want = jax.jit(jds.subm_conv_dense, static_argnums=3)(
                jnp.asarray(x, jdt), jnp.asarray(occ, jdt), jnp.asarray(w), k)
            got = ds.subm_conv_dense(t(x, tdt), t(occ, tdt), t(w), k)
            mask = occ
        else:
            want, wocc = jax.jit(jds.sparse_conv_down_dense, static_argnums=(3, 4, 5))(
                jnp.asarray(x, jdt), jnp.asarray(occ, jdt), jnp.asarray(w), k, s, p)
            got, gocc = ds.sparse_conv_down_dense(t(x, tdt), t(occ, tdt), t(w), k, s, p)
            np.testing.assert_array_equal(gocc.float().numpy(), np.array(wocc, np.float32))
            mask = np.array(wocc, np.float32)
        assert got.dtype == tdt and got.shape == want.shape
        want = np.array(want, np.float32)
        got = got.float().numpy()
        scale = float(np.abs(want).max())
        assert scale > 0 and float(np.abs(got - want).max()) <= tol * scale, (k, s)
        assert not np.any(got[mask == 0])  # inactive cells stay zero


def test_masked_mean_var():
    (jd, jo), (td, to) = _grid(16, 2)
    x = np.random.RandomState(3).randn(*jd.shape).astype(np.float32) * jo[..., None]
    want = jds.masked_mean_var(jnp.asarray(x), jnp.asarray(jo))
    got = ds.masked_mean_var(t(x), to)
    for g, w in zip(got, want):
        w = np.array(w)
        assert g.dtype == torch.float32
        assert float(np.abs(g.numpy() - w).max()) <= 1e-6 * float(np.abs(w).max())
