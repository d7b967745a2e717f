"""Port parity: gradients of the banded gather-GEMM
(dal3d_tpu_torch/ops/banded.py, a torch.autograd.Function) against
dal3d_tpu/ops/banded.py's custom_vjp and against autodiff of the dense
reference, in f32 on the CPU (the port runs the plain versions of its
kernels). rtol/atol 1e-4: summation order only."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.ops import banded as bd
from dal3d_tpu_torch.ops import banded as tbd
from dal3d_tpu_torch.ops import sparse_brick as tspb
from torch_port_utils import mk_rulebook, small_voxels, t


def _symmetric_case(seed, B=1, M=256, R=128, Rout=128):
    """The setting of tests/test_banded.py::test_banded_grad_matches_reference:
    taps (-2, self, +2), a tap-symmetric rulebook."""
    rng = np.random.RandomState(seed)
    m = np.arange(M)
    idx = np.stack([np.clip(m - 2, 0, M - 1), m, np.clip(m + 2, 0, M - 1)])[None]
    idx = np.tile(idx, (B, 1, 1)).astype(np.int32)
    hit = np.ones((B, 3, M), bool)
    hit[:, 0, :2] = False
    hit[:, 2, -2:] = False
    table = rng.randn(B, M, R).astype(np.float32)
    w = (rng.randn(3, R, Rout) * 0.1).astype(np.float32)
    return idx, hit, table, w


def _jax_dense_grads(idx, hit, table, w, Mb):
    """jax.grad of sum(sin(dense masked gather + einsum))."""
    B, Q, M = idx.shape
    idxj, hitj = jnp.asarray(idx), jnp.asarray(hit)

    def loss(tb, wb):
        tn = jnp.concatenate([tb, jnp.zeros((B, 1, tb.shape[-1]), tb.dtype)], 1)
        safe = jnp.where(hitj, idxj, Mb)
        g = jnp.take_along_axis(tn, safe.reshape(B, Q * M, 1), axis=1).reshape(B, Q, M, -1)
        return jnp.sum(jnp.sin(jnp.einsum("bqmr,qro->bmo", g, wb)))

    return [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1))(jnp.asarray(table),
                                                                  jnp.asarray(w))]


def _port_grads(idx, hit, table, w, symmetric):
    tb = t(table).requires_grad_(True)
    wt = t(w).requires_grad_(True)
    out = tbd.banded_gather_matmul(tb, wt, t(np.where(hit, idx, -1)), symmetric=symmetric)
    torch.sin(out).sum().backward()
    return tb.grad.numpy(), wt.grad.numpy()


def test_symmetric_grad_matches_jax_custom_vjp():
    """K1 again with reversed taps and transposed weights for dtable, the dw
    twin for the weights, against jax.grad through JAX's banded op (symmetric
    band plan + fallback) and through the dense reference."""
    idx, hit, table, w = _symmetric_case(2)
    plan = bd.make_band_plan(jnp.asarray(idx), jnp.asarray(hit), 256, band=128, fb_cap=1024,
                             symmetric=True)
    gt, gw = jax.grad(lambda a, b: jnp.sum(jnp.sin(bd.banded_gather_matmul(a, b, plan))),
                      argnums=(0, 1))(jnp.asarray(table), jnp.asarray(w))
    rt, rw = _jax_dense_grads(idx, hit, table, w, 256)
    pt, pw = _port_grads(idx, hit, table, w, symmetric=True)
    for got, a, b in ((pt, gt, rt), (pw, gw, rw)):
        np.testing.assert_allclose(got, np.asarray(a), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, b, rtol=1e-4, atol=1e-4)
    # the scatter route computes the same input gradient on this rulebook
    st, sw = _port_grads(idx, hit, table, w, symmetric=False)
    np.testing.assert_allclose(st, pt, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sw, pw, rtol=1e-5, atol=1e-5)


def test_asymmetric_grad_matches_jax_dense_reference():
    """A random rulebook with M != Mb (the strided conv's kind): matmul +
    index_add_ input gradient, against jax.grad of the dense reference."""
    rng = np.random.RandomState(4)
    B, Q, M, Mb, R, Rout = 2, 5, 96, 80, 24, 40
    idx, hit = mk_rulebook(rng, B, Q, M, Mb, spread=12)
    table = rng.randn(B, Mb, R).astype(np.float32)
    w = (rng.randn(Q, R, Rout) * 0.2).astype(np.float32)
    rt, rw = _jax_dense_grads(idx, hit, table, w, Mb)
    pt, pw = _port_grads(idx, hit, table, w, symmetric=False)
    np.testing.assert_allclose(pt, rt, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pw, rw, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="M == Mb"):
        _port_grads(idx, hit, table, w, symmetric=True)


def test_dw_plain_matches_pallas_interpret():
    """banded_dw_plain against JAX's _dw_kernel in interpret mode on the
    plan's in-band rulebook (all the Pallas kernel sees)."""
    rng = np.random.RandomState(8)
    B, Q, M = 2, 3, 256
    idx, hit = mk_rulebook(rng, B, Q, M, M, spread=40)
    table = rng.randn(B, M, 128).astype(np.float32)
    g = (rng.randn(B, M, 128) * 0.1).astype(np.float32)
    plan = bd.make_band_plan(jnp.asarray(idx), jnp.asarray(hit), M, band=128, fb_cap=512)
    os.environ["DAL3D_BANDED"] = "interpret"
    try:
        ref = np.asarray(bd._banded_dw_pallas(jnp.asarray(table), plan.idx_k, plan.starts,
                                              jnp.asarray(g), plan.groups, plan.bands, plan.bm))
    finally:
        del os.environ["DAL3D_BANDED"]
    got = tbd.banded_dw_plain(t(table), t(plan.idx_k), t(g))
    assert got.dtype == torch.float32 and got.shape == (Q, 128, 128)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(tbd.banded_dw(t(table), t(plan.idx_k), t(g)), got)  # CPU: the plain version


@pytest.mark.parametrize("symmetric", [True, False])
def test_gradcheck_f64(symmetric):
    idx, hit, table, w = _symmetric_case(5, B=2, M=12, R=4, Rout=3)
    tb = t(table, torch.float64).requires_grad_(True)
    wt = t(w, torch.float64).requires_grad_(True)
    ix = t(np.where(hit, idx, -1))
    assert torch.autograd.gradcheck(
        lambda a, b: tbd.banded_gather_matmul(a, b, ix, symmetric=symmetric), (tb, wt),
        eps=1e-6, atol=1e-6)


def _is_tap_symmetric(idx: torch.Tensor) -> bool:
    """idx[b, Q-1-q, idx[b, q, m]] == m on every hit."""
    B, Q, M = idx.shape
    rev = idx.flip(1)  # rev[b, q] = idx[b, Q-1-q]
    back = torch.gather(rev, 2, idx.clamp(min=0).long())
    rows = torch.arange(M).expand(B, Q, M)
    return bool(((idx < 0) | (back == rows)).all())


@pytest.mark.parametrize("mb_cap", [1536, 300])
def test_subm_and_pad_rulebooks_are_tap_symmetric(mb_cap):
    """The rulebooks subm_rulebook_banded and _pad_rulebook build are
    tap-symmetric, also when the brick capacity drops bricks (mb_cap 300),
    and also the strided conv's halo-pad rulebook; a strided conv's own
    rulebook is not (M != Mb)."""
    vf, vc, vv = small_voxels(1)
    bb = tspb.from_voxels(t(vf), t(vc), t(vv), (41, 64, 64), bw=8, mb_cap=mb_cap)
    n_bricks = int((bb.brick_lin < bb.num_cells).sum(1).min())
    assert (n_bricks == mb_cap) == (mb_cap == 300)  # the small capacity overflows
    rb = tspb.subm_rulebook_banded(bb, 3)
    assert rb.conv.shape[1] == 9 and rb.pad.shape[1] == 3
    assert int((rb.conv >= 0).sum()) > n_bricks and int((rb.pad[:, 0] >= 0).sum()) > 0
    assert _is_tap_symmetric(rb.conv) and _is_tap_symmetric(rb.pad)
    out_lin, idx, _, _, halo = tspb.downsample_plan(bb, (3, 3, 3), (2, 2, 2), (1, 1, 1), 8, 384)
    assert _is_tap_symmetric(tspb._pad_rulebook(halo))
    assert idx.shape[2] != bb.brick_lin.shape[1]
    # the check itself sees a broken pair
    broken = rb.conv.clone()
    b, m = (broken[:, 0] >= 0).nonzero()[0].tolist()
    broken[b, 8, broken[b, 0, m]] = -1  # drop the dual of a hit of tap 0
    assert not _is_tap_symmetric(broken)


def test_no_weight_gradient_kernel_for_constant_weights(monkeypatch):
    """A subm conv launches one weight-gradient call (the conv; the halo pad's
    selection weights are constants), none when its weight does not train,
    and no input gradient for a table that needs none."""
    calls = {"dw": 0, "fwd": 0}
    dw, fwd = tbd.banded_dw, tbd.banded_conv
    monkeypatch.setattr(tbd, "banded_dw", lambda *a: calls.__setitem__("dw", calls["dw"] + 1) or dw(*a))
    monkeypatch.setattr(tbd, "banded_conv", lambda *a: calls.__setitem__("fwd", calls["fwd"] + 1) or fwd(*a))
    vf, vc, vv = small_voxels(2, B=1, N=300)
    bb = tspb.from_voxels(t(vf), t(vc), t(vv), (41, 64, 64), bw=8, mb_cap=384)
    rb = tspb.subm_rulebook_banded(bb, 3)
    rng = np.random.RandomState(0)
    w = t((rng.randn(27, 5, 8) * 0.1).astype(np.float32))

    def run(feat_grad, w_grad):
        calls.update(dw=0, fwd=0)
        x = bb.replace(features=bb.features.clone().requires_grad_(feat_grad))
        out = tspb.subm_conv(x, w.clone().requires_grad_(w_grad), rb)
        fwd_calls = calls["fwd"]
        out.features.sum().backward()
        return fwd_calls, calls["fwd"] - fwd_calls, calls["dw"]

    assert run(True, True) == (2, 2, 1)  # pad + conv forward, two dual gathers, one dw
    assert run(True, False) == (2, 2, 0)
    assert run(False, True) == (2, 0, 1)  # the stem: no input gradient at all
