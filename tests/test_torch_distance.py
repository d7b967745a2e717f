"""Pairwise L1 / L2 distances of the PyTorch port (plain versions, on the
CPU) against the JAX package: ``ops.distance.pairwise_l1 / _l2`` (XLA) and
the Pallas kernels in interpret mode.

Tolerances: L1 sums C terms of one sign in another order, rtol 1e-5. L2 is
compared on squared distances, where the Gram expression cancels: atol 1e-6
of the scale |x|^2 + |y|^2 (distances themselves only away from the
diagonal, where the square root of rounding noise differs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.ops import distance as jd
from dal3d_tpu.ops.pallas_distance import pairwise_l1_pallas, pairwise_l2_pallas
from dal3d_tpu_torch.ops import distance as td
from torch_port_utils import t

SHAPES = [(37, 53, 16), (1, 300, 512), (260, 130, 512), (300, 257, 96), (5, 5, 16)]


def _xy(N, M, C, seed):
    rng = np.random.RandomState(seed)
    # embeddings are non-negative (ReLU, pooling)
    return (np.abs(rng.randn(N, C)).astype(np.float32),
            np.abs(rng.randn(M, C)).astype(np.float32))


@pytest.mark.parametrize("N,M,C", SHAPES)
def test_l1_matches_jax(N, M, C):
    x, y = _xy(N, M, C, 0)
    got = td.pairwise_l1(t(x), t(y)).numpy()
    assert got.shape == (N, M)
    np.testing.assert_allclose(got, np.asarray(jd.pairwise_l1(jnp.asarray(x), jnp.asarray(y))),
                               rtol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(pairwise_l1_pallas(jnp.asarray(x), jnp.asarray(y), interpret=True)),
        rtol=1e-5)


@pytest.mark.parametrize("N,M,C", SHAPES)
def test_l2_matches_jax(N, M, C):
    x, y = _xy(N, M, C, 1)
    scale = (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
    got2 = td.pairwise_l2(t(x), t(y), squared=True).numpy()
    ref2 = np.asarray(jd.pairwise_l2(jnp.asarray(x), jnp.asarray(y), squared=True))
    assert got2.shape == (N, M)
    assert float(np.max(np.abs(got2 - ref2) / scale)) <= 1e-6
    got = td.pairwise_l2(t(x), t(y)).numpy()
    np.testing.assert_allclose(got, np.sqrt(got2), rtol=1e-6)
    pal = np.asarray(pairwise_l2_pallas(jnp.asarray(x), jnp.asarray(y), interpret=True))
    # the Pallas kernel returns distances: squaring them back adds two roundings
    assert float(np.max(np.abs(got * got - pal * pal) / scale)) <= 3e-6
    # distinct random rows are far apart: distances agree too
    np.testing.assert_allclose(got, np.asarray(jd.pairwise_l2(jnp.asarray(x), jnp.asarray(y))),
                               rtol=1e-4)


def test_l2_self_distance_is_noise_not_zero():
    """d(x, x) by the Gram expression is sqrt of rounding noise of order
    eps * |x|^2: small against |x|, and never negative or NaN."""
    x, _ = _xy(64, 1, 512, 2)
    d = td.pairwise_l2(t(x), t(x)).numpy()
    diag = np.diagonal(d)
    assert np.all(np.isfinite(d)) and np.all(d >= 0)
    assert float(diag.max()) <= 1e-2 * float(np.sqrt((x * x).sum(1)).min())


def test_plain_l1_blocks_do_not_change_the_result(monkeypatch):
    x, y = _xy(50, 40, 16, 3)
    whole = td.pairwise_l1_plain(t(x), t(y))
    monkeypatch.setattr(td, "_PLAIN_L1_FLOATS", 40 * 16 * 7)  # 7-row blocks
    assert torch.equal(td.pairwise_l1_plain(t(x), t(y)), whole)


def test_pairwise_dispatch():
    x, y = _xy(4, 6, 16, 4)
    assert torch.equal(td.pairwise(t(x), t(y), "l1"), td.pairwise_l1(t(x), t(y)))
    assert torch.equal(td.pairwise(t(x), t(y), "euclidean"), td.pairwise_l2(t(x), t(y)))
    with pytest.raises(ValueError):
        td.pairwise(t(x), t(y), "cosine")
