"""Port parity of the gather engine's grid plans (dal3d_tpu_torch/ops/
sparse_grid.py) against dal3d_tpu/ops/sparse_grid.py on the CPU.

Integer plans are bit-identical: the index grid, the subm rulebook (idx and
hit), the downsample plan (out_lin in ascending cell order, idx, hit), with a
cap below the occupied set, the (0, 1, 1) padding of the encoder's down 2
and the (3, 1, 1) / (2, 1, 1) conv_out; to_dense keeps channel c*D + d; the
f32 convs agree within 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.ops import sparse as jsp
from dal3d_tpu.ops import sparse_grid as jspg
from dal3d_tpu_torch.ops import sparse as tsp
from dal3d_tpu_torch.ops import sparse_grid as tspg
from torch_port_utils import t

SHAPE = (7, 12, 10)  # odd D, as the encoder's levels


def _voxels(seed, B=2, N=96, n_active=(80, 61), shape=SHAPE, C=4):
    """Rows in random order with padding rows mixed in; unique cells."""
    rng = np.random.RandomState(seed)
    D, H, W = shape
    feats = np.zeros((B, N, C), np.float32)
    coords = np.zeros((B, N, 3), np.int32)
    valid = np.zeros((B, N), bool)
    for b in range(B):
        rows = rng.permutation(N)[:n_active[b]]
        lin = rng.choice(D * H * W, size=n_active[b], replace=False)
        coords[b, rows] = np.stack([lin // (H * W), (lin // W) % H, lin % W], axis=1)
        feats[b, rows] = rng.randn(n_active[b], C)
        valid[b, rows] = True
    j = jspg.from_voxels(jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(valid), shape)
    p = tspg.from_voxels(t(feats), t(coords), t(valid), shape)
    return j, p


def test_from_voxels_and_index_grid_bit_identical():
    j, p = _voxels(0)
    np.testing.assert_array_equal(p.lin.numpy(), np.asarray(j.lin))
    np.testing.assert_array_equal(p.features.numpy(), np.asarray(j.features))
    np.testing.assert_array_equal(tspg.build_index_grid(p).numpy(),
                                  np.asarray(jspg.build_index_grid(j)))


@pytest.mark.parametrize("ks", [3, (3, 1, 1)])
def test_subm_rulebook_bit_identical(ks):
    j, p = _voxels(1)
    ji, jh = jspg.subm_rulebook(j, ks)
    pi, ph = tspg.subm_rulebook(p, ks)
    assert pi.dtype == torch.int32 and ph.dtype == torch.bool
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))


# (kernel, stride, padding, cap): the encoder's down 0/1, down 2 and conv_out,
# and a cap below the occupied output set (truncation keeps the lowest cells)
PLANS = [
    ((3, 3, 3), (2, 2, 2), (1, 1, 1), 128),
    ((3, 3, 3), (2, 2, 2), (0, 1, 1), 128),
    ((3, 1, 1), (2, 1, 1), (0, 0, 0), 128),
    ((3, 3, 3), (2, 2, 2), (1, 1, 1), 20),
]


@pytest.mark.parametrize("ks,st,pad,cap", PLANS)
def test_downsample_plan_bit_identical(ks, st, pad, cap):
    j, p = _voxels(2)
    jl, ji, jh, jshape = jspg.downsample_plan(j, ks, st, pad, cap)
    pl, pi, ph, pshape = tspg.downsample_plan(p, ks, st, pad, cap)
    assert pshape == tuple(jshape)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(jh))
    valid = pl.numpy() < np.prod(pshape)
    for b in range(2):  # ascending cell order, padding after
        lin = pl.numpy()[b][valid[b]]
        assert np.all(np.diff(lin) > 0) and valid[b].sum() == len(lin)
    if cap == 20:
        assert valid.all()  # the occupied set overflows the cap


@pytest.mark.parametrize("ks,st,pad,cap", PLANS[1:3])
def test_convs_and_to_dense_match_jax(ks, st, pad, cap):
    j, p = _voxels(3)
    rng = np.random.RandomState(4)
    K = int(np.prod(ks))
    w1 = (rng.randn(27, 4, 6) * 0.3).astype(np.float32)
    w2 = (rng.randn(K, 6, 5) * 0.3).astype(np.float32)
    js = jspg.subm_conv(j, jnp.asarray(w1))
    ps = tspg.subm_conv(p, t(w1))
    np.testing.assert_allclose(ps.features.numpy(), np.asarray(js.features), rtol=1e-5, atol=1e-5)
    jd = jspg.sparse_conv_downsample(js, jnp.asarray(w2), ks, st, pad, cap)
    pd = tspg.sparse_conv_downsample(ps, t(w2), ks, st, pad, cap)
    np.testing.assert_array_equal(pd.lin.numpy(), np.asarray(jd.lin))
    np.testing.assert_allclose(pd.features.numpy(), np.asarray(jd.features), rtol=1e-5,
                               atol=1e-5)
    dense = tsp.to_dense(pd)
    D, H, W = pd.shape
    assert dense.shape == (2, H, W, 5 * D)
    np.testing.assert_allclose(dense.numpy(), np.asarray(jsp.to_dense(jd)), rtol=1e-5,
                               atol=1e-5)


def test_to_dense_channel_order():
    """channel c*D + d holds feature c of the voxel at depth d."""
    D, H, W = 3, 2, 2
    lin = torch.tensor([[(2 * H + 1) * W + 0, D * H * W]], dtype=torch.int32)
    feats = torch.tensor([[[1.0, 2.0], [9.0, 9.0]]])
    dense = tsp.to_dense(tsp.SparseBatch(features=feats, lin=lin, shape=(D, H, W)))
    want = np.zeros((1, H, W, 2 * D), np.float32)
    want[0, 1, 0, 0 * D + 2], want[0, 1, 0, 1 * D + 2] = 1.0, 2.0
    np.testing.assert_array_equal(dense.numpy(), want)
    jd = jsp.to_dense(jsp.SparseBatch(features=jnp.asarray(feats.numpy()),
                                      lin=jnp.asarray(lin.numpy()), shape=(D, H, W)))
    np.testing.assert_array_equal(np.asarray(jd), want)
