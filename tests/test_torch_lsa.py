"""Port parity of the Hungarian assignment (dal3d_tpu_torch/ops/lsa.py)
against the JAX package's ``ops/lsa.py::linear_sum_assignment`` on the CPU.

The plain version is JAX's algorithm in the same f32 arithmetic, so on
seeded tie-free costs its ``col4row`` equals JAX's, padded rows (the loss's
1e6 constant rows) included; its total cost equals scipy's optimum within
1e-5 of scale. Shapes: square, G < P, G > P (the transposed problem, rows
left at -1), and a batch; and integer costs full of ties, where the
argmin's tie rule decides. The kernel is held to this plain version on the
card (tests/test_torch_kernels_cuda.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment as scipy_lsa

from dal3d_tpu.ops.lsa import linear_sum_assignment as jax_lsa
from dal3d_tpu_torch.ops import lsa as tl
from torch_port_utils import t

_jax = jax.jit(jax.vmap(jax_lsa))


@pytest.mark.parametrize("B,G,P,pad", [(3, 12, 12, 0), (2, 9, 20, 4), (2, 14, 6, 3),
                                       (1, 1, 1, 0)])
def test_plain_matches_jax_and_scipy(B, G, P, pad):
    rng = np.random.RandomState(G * 100 + P)
    cost = (rng.rand(B, G, P) * 2 - 0.5).astype(np.float32)
    if pad:
        cost[:, G - pad:] = 1e6
    got = tl.linear_sum_assignment(t(cost))
    assert got.dtype == torch.int32 and got.shape == (B, G)
    np.testing.assert_array_equal(got.numpy(), np.asarray(_jax(jnp.asarray(cost))))
    for b in range(B):
        c4r = got[b].numpy()
        m = c4r >= 0
        assert int(m.sum()) == min(G, P) and len(set(c4r[m].tolist())) == min(G, P)
        r, c = scipy_lsa(cost[b].astype(np.float64))
        want = float(cost[b][r, c].sum(dtype=np.float64))
        have = float(cost[b][np.arange(G)[m], c4r[m]].sum(dtype=np.float64))
        assert abs(have - want) <= 1e-5 * max(abs(want), 1.0)


def test_plain_matches_jax_on_tied_integer_costs():
    """Integer costs in [0, 3] (most rows hold several equal least values,
    so the argmin's tie rule, the first least column, decides the matching)
    with 5 padded rows: col4row equal to JAX's, the total cost equal to
    scipy's (the card kernel is held to this plain version on the same kind
    of cost)."""
    rng = np.random.RandomState(7)
    cost = rng.randint(0, 4, (2, 16, 18)).astype(np.float32)
    cost[:, 11:] = 1e6
    got = tl.linear_sum_assignment(t(cost))
    np.testing.assert_array_equal(got.numpy(), np.asarray(_jax(jnp.asarray(cost))))
    for b in range(2):
        c4r = got[b].numpy()
        assert len(set(c4r.tolist())) == 16
        r, c = scipy_lsa(cost[b].astype(np.float64))
        assert float(cost[b][np.arange(16), c4r].sum()) == float(cost[b][r, c].sum())


def test_padding_rows_leave_the_valid_rows_optimal():
    """Constant rows appended to a problem: the valid rows' assignment keeps
    the optimal cost of the problem without them (here also the same
    columns), and a 2-D cost gives the unbatched answer."""
    rng = np.random.RandomState(3)
    valid = rng.rand(5, 9).astype(np.float32)
    padded = np.concatenate([valid, np.full((4, 9), 1e6, np.float32)])
    a = tl.linear_sum_assignment(t(valid))
    b = tl.linear_sum_assignment(t(padded))
    assert a.shape == (5,) and b.shape == (9,)
    r, c = scipy_lsa(valid)
    assert float(valid[np.arange(5), b[:5].numpy()].sum()) == pytest.approx(
        float(valid[r, c].sum()), rel=1e-6)
    assert torch.equal(a, b[:5])


def test_wrapper_counts_nothing_on_cpu_and_refuses_other_devices():
    n = tl.linear_sum_assignment.launches
    assert isinstance(n, int)
    tl.linear_sum_assignment(torch.rand(2, 3, 4))
    assert tl.linear_sum_assignment.launches == n
    with pytest.raises(ValueError):
        tl.linear_sum_assignment(torch.zeros(1, 3, 4, device="meta"))
