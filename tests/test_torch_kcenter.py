"""Budgeted greedy k-center of the PyTorch port (CPU) against the JAX
package's ``kcenter_matrix`` / ``kcenter_features`` and the numpy oracle:
selected indices equal, cost within rtol 1e-6 (both accumulate in f32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.ops import kcenter as jk
from dal3d_tpu_torch.ops import kcenter as tk
from torch_port_utils import t

N = 60


def rand_dist(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 3)
    return np.sqrt(((x[:, None] - x[None, :]) ** 2).sum(-1)).astype(np.float32)


def _jax_matrix(d, costs, budget, init, first, already, max_select):
    sel, count, cost = jk.kcenter_matrix(
        jnp.asarray(d), jnp.asarray(costs), jnp.asarray(np.float32(budget)), jnp.asarray(init),
        jnp.asarray(np.int32(first)), jnp.asarray(already), max_select=max_select)
    return np.asarray(sel), int(count), float(cost)


def _torch_matrix(d, costs, budget, init, first, already, max_select):
    sel, count, cost = tk.kcenter_matrix(t(d), t(costs), np.float32(budget), t(init), first,
                                         t(already), max_select=max_select)
    assert sel.dtype == torch.int32 and sel.shape == (max_select,)
    return sel.numpy(), int(count), float(cost)


def _case(name):
    """(dist, costs, budget, init_fps, first, already, max_select)"""
    if name == "fresh":
        return (rand_dist(N, 1), np.full(N, 0.2, np.float32), 4.0,
                np.full(N, np.inf, np.float32), 3, np.zeros(N, bool), N)
    if name == "prior":
        d = rand_dist(N, 2)
        already = np.zeros(N, bool)
        already[[5, 10, 15]] = True
        init = d[[5, 10, 15]].min(0)
        first = int(np.argmax(np.where(already, -np.inf, init)))
        rng = np.random.RandomState(3)
        costs = (0.12 + 0.04 * rng.randint(0, 30, N)).astype(np.float32)
        return d, costs, 9.0, init, first, already, N
    if name == "exhaustion":  # pool restricted to {0, 1, 2}
        d = rand_dist(10, 5)
        d[3:, :] = -np.inf
        d[:, 3:] = -np.inf
        init = np.full(10, np.inf, np.float32)
        init[3:] = -np.inf
        return d, np.full(10, 0.1, np.float32), 100.0, init, 0, np.zeros(10, bool), 10
    if name == "first_over_budget":
        return (rand_dist(N, 6), np.full(N, 0.5, np.float32), 0.3,
                np.full(N, np.inf, np.float32), 7, np.zeros(N, bool), N)
    if name == "max_select":
        return (rand_dist(N, 7), np.full(N, 0.1, np.float32), 100.0,
                np.full(N, np.inf, np.float32), 0, np.zeros(N, bool), 5)
    if name == "f32_boundary":
        # ten picks of 0.1f sum to 1.0000001 in f32 (over a budget of 1.0)
        # and to 1.0000000149 in f64 (over too), nine to 0.9000001: the
        # budget sits exactly on an f32 sum so one ulp decides the last pick
        costs = np.full(N, 0.1, np.float32)
        acc = np.float32(0)
        for _ in range(7):
            acc = np.float32(acc + np.float32(0.1))
        return (rand_dist(N, 8), costs, float(acc), np.full(N, np.inf, np.float32), 1,
                np.zeros(N, bool), N)
    raise KeyError(name)


CASES = ["fresh", "prior", "exhaustion", "first_over_budget", "max_select", "f32_boundary"]


@pytest.mark.parametrize("name", CASES)
def test_kcenter_matrix_matches_jax_and_numpy(name):
    d, costs, budget, init, first, already, max_select = _case(name)
    jsel, jcount, jcost = _jax_matrix(d, costs, budget, init, first, already, max_select)
    tsel, tcount, tcost = _torch_matrix(d, costs, budget, init, first, already, max_select)
    assert tcount == jcount
    np.testing.assert_array_equal(tsel, jsel)
    np.testing.assert_allclose(tcost, jcost, rtol=1e-6)
    if name not in ("max_select", "f32_boundary"):  # the oracle has no cap, and sums in f64
        ref, ref_cost = tk.kcenter_numpy(d, costs, budget, init, first, already)
        assert tsel[:tcount].tolist() == ref
        np.testing.assert_allclose(tcost, ref_cost, rtol=1e-5)
    got = tsel[:tcount].tolist()
    assert len(got) == len(set(got)) and not set(got) & set(np.flatnonzero(already).tolist())
    assert np.all(tsel[tcount:] == -1)


def test_f32_boundary_keeps_the_pick_that_lands_on_the_budget():
    d, costs, budget, init, first, already, max_select = _case("f32_boundary")
    _, count, cost = _torch_matrix(d, costs, budget, init, first, already, max_select)
    assert count == 7 and np.float32(cost) == np.float32(budget)


@pytest.mark.parametrize("metric", ["l1", "l2"])
@pytest.mark.parametrize("prior", [False, True])
def test_kcenter_features_matches_jax_and_matrix(metric, prior):
    rng = np.random.RandomState(11)
    n = 80
    f = np.abs(rng.randn(n, 16)).astype(np.float32)
    costs = (0.12 + 0.04 * rng.randint(0, 30, n)).astype(np.float32)
    already = np.zeros(n, bool)
    if prior:
        already[[2, 40, 41]] = True
        from dal3d_tpu_torch.ops.distance import pairwise
        init = pairwise(t(f[already]), t(f), metric).min(0).values.numpy()
        first = int(np.argmax(np.where(already, -np.inf, init)))
    else:
        init, first = np.full(n, np.inf, np.float32), 9
    jsel, jcount, jcost = jk.kcenter_features(
        jnp.asarray(f), jnp.asarray(costs), jnp.asarray(np.float32(12.0)), jnp.asarray(init),
        jnp.asarray(np.int32(first)), jnp.asarray(already), max_select=n, metric=metric)
    tsel, tcount, tcost = tk.kcenter_features(t(f), t(costs), np.float32(12.0), t(init), first,
                                              t(already), max_select=n, metric=metric)
    assert tcount == int(jcount) > 3
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    np.testing.assert_allclose(float(tcost), float(jcost), rtol=1e-6)
    # the streaming variant picks what the materialized map picks
    from dal3d_tpu_torch.ops.distance import pairwise
    msel, mcount, _ = tk.kcenter_matrix(pairwise(t(f), t(f), metric), t(costs), np.float32(12.0),
                                        t(init), first, t(already), max_select=n)
    assert mcount == tcount and torch.equal(msel, tsel)
