"""Port parity of the gather engine's gradients (dal3d_tpu_torch/ops/gather.py)
against the JAX package on the CPU.

JAX differentiates ``ops/sparse.py::gather_gemm`` and ``take_along_axis``
with XLA (it has no Pallas backward); the port's plain versions are
differentiated by autograd, and on the card each launch sits in an
autograd Function whose dX is K4 over the inverse rulebook and whose dW is
the K4-dW kernel. Here, on rulebooks of ``ops/sparse_grid.py`` (the shared
subm rulebook with its sorted symmetric plan, the strided downsample, the
conv_out squash):

- the plain autograd against ``jax.grad`` (1e-5 of each gradient's scale);
- the Function's routes, with each launch replaced by a plain emulation of
  what the kernel computes over its plan (the rows taken in plan order,
  written back through ``order``), against that autograd: the same padding,
  the reversed taps of a symmetric plan, the scatter-built inverse of a
  strided one, dW over the plan (1e-5);
- the row gather's backward with repeated rows against ``jax.grad`` of
  ``take_along_axis`` (1e-6);
- each strided inverse rulebook is injective per tap and inverts it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dal3d_tpu.ops.sparse import gather_gemm as jax_gather_gemm
from dal3d_tpu_torch.ops import gather as tg
from dal3d_tpu_torch.ops import sparse_backend as sp
from torch_port_utils import small_voxels, t

SHAPE = (41, 64, 64)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The lane runs several workers side by side: a full set of intra-op
    threads in each makes them fight for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _level(Cin, seed=0):
    """Clustered voxels with Cin features, their index grid and the shared
    subm rulebook with its sorted symmetric plan."""
    vf, vc, vv = small_voxels(seed, N=1500)
    rng = np.random.RandomState(seed + 1)
    f = np.where(vv[..., None], rng.randn(*vv.shape, Cin), 0.0).astype(np.float32)
    sb = sp.from_voxels(t(f), t(vc), t(vv), SHAPE)
    grid = sp.build_index_grid(sb)
    return sb, grid, sp.with_plan(sp.subm_rulebook(sb, 3, grid))


def _rulebook(kind, sb, grid, rb):
    """(idx, hit, plan) of one conv kind on the level."""
    if kind == "subm":
        return rb
    ks, st, pad, cap = ((3, 2, 1, 1000) if kind == "down" else ((3, 1, 1), (2, 1, 1), 0, 1500))
    _, idx, hit, _ = sp.downsample_plan(sb, ks, st, pad, cap, grid)
    return idx, hit, tg.gather_plan(idx, hit, sort=False)


CASES = [("subm", 16, 16), ("subm", 5, 16), ("down", 16, 32), ("conv_out", 64, 64)]


def _inputs(kind, Cin, Cout):
    sb, grid, rb = _level(Cin)
    idx, hit, plan = _rulebook(kind, sb, grid, rb)
    rng = np.random.RandomState(Cin + Cout)
    w = (rng.randn(idx.shape[1], Cin, Cout) * 0.1).astype(np.float32)
    g = rng.randn(idx.shape[0], idx.shape[2], Cout).astype(np.float32)
    return sb.features, idx, hit, plan, t(w), t(g)


def _plain_grads(x, idx, hit, w, g):
    x, w = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    (tg.gather_gemm_plain(x, idx, hit, w) * g).sum().backward()
    return x.grad, w.grad


def _close(got, ref, rel):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = ref.detach().numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= rel * float(np.abs(ref).max()), \
        (float(np.abs(got - ref).max()), float(np.abs(ref).max()))


@pytest.mark.parametrize("kind,Cin,Cout", CASES)
def test_plain_autograd_matches_jax_grad(kind, Cin, Cout):
    x, idx, hit, _, w, g = _inputs(kind, Cin, Cout)
    dx, dw = _plain_grads(x, idx, hit, w, g)
    jx, jw = jax.grad(lambda a, b: (jax_gather_gemm(a, jnp.asarray(idx.numpy()),
                                                   jnp.asarray(hit.numpy()), b)
                                   * jnp.asarray(g.numpy())).sum(), argnums=(0, 1))(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()))
    _close(dx, jx, 1e-5)
    _close(dw, jw, 1e-5)
    assert float(dx.abs().max()) > 0 and float(dw.abs().max()) > 0


def _kernel_over_plan(features, plan, weights):
    """What csrc/gather.cu::gather_gemm_f32 computes over a plan, in plain
    PyTorch: the rows in plan order, each written to its row order[p]."""
    rb = plan.rulebook
    out = tg.gather_gemm_plain(features, torch.clamp(rb, min=0), rb >= 0, weights)
    if plan.order is not None:
        out = torch.empty_like(out).scatter_(1, plan.order[..., None].expand_as(out), out)
    tg.gather_gemm.launches += 1
    return out


def _dw_over_plan(features, plan, g):
    """What csrc/gather.cu::gather_dw_f32 computes over a plan: g's rows taken
    in plan order."""
    rb = plan.rulebook
    if plan.order is not None:
        g = torch.gather(g, 1, plan.order[..., None].expand_as(g))
    tg.gather_dw.launches += 1
    return tg.gather_dw_plain(features, torch.clamp(rb, min=0), rb >= 0, g)


@pytest.mark.parametrize("kind,Cin,Cout", CASES)
def test_function_routes_match_plain_autograd(kind, Cin, Cout, monkeypatch):
    """The card's autograd Function with its launches emulated: the pads
    around it (Cin 5 -> 8, its dX launch's Cout 8 padded to a column tile and
    cut back), one forward, one dX and one dW launch."""
    monkeypatch.setattr(tg, "_launch_gemm", _kernel_over_plan)
    monkeypatch.setattr(tg, "_launch_dw", _dw_over_plan)
    x, idx, hit, plan, w, g = _inputs(kind, Cin, Cout)
    assert plan.symmetric == (kind == "subm")
    dx, dw = _plain_grads(x, idx, hit, w, g)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    n4, nw = tg.gather_gemm.launches, tg.gather_dw.launches
    Cinp, Coutp = -(-Cin // 4) * 4, tg._cout_pad(Cout)
    out = tg._GatherGemm.apply(F.pad(xr, (0, Cinp - Cin)),
                               F.pad(wr, (0, Coutp - Cout, 0, Cinp - Cin)), plan)[..., :Cout]
    _close(out, tg.gather_gemm_plain(x, idx, hit, w), 1e-6)
    (out * g).sum().backward()
    assert (tg.gather_gemm.launches - n4, tg.gather_dw.launches - nw) == (2, 1)
    _close(xr.grad, dx, 1e-5)
    _close(wr.grad, dw, 1e-5)


def test_dw_plain_twin_is_the_weight_gradient():
    x, idx, hit, _, w, g = _inputs("subm", 16, 32)
    _, dw = _plain_grads(x, idx, hit, w, g)
    _close(tg.gather_dw(x, idx, hit, g), dw, 1e-6)
    n = tg.gather_dw.launches
    assert isinstance(n, int) and tg.gather_dw.launches == n  # the CPU path counts nothing
    with pytest.raises(ValueError):
        tg.gather_dw(torch.zeros(1, 4, 8, device="meta"),
                     torch.zeros(1, 2, 3, dtype=torch.int32, device="meta"),
                     torch.zeros(1, 2, 3, dtype=torch.bool, device="meta"),
                     torch.zeros(1, 3, 16, device="meta"))


@pytest.mark.parametrize("kind", ["down", "conv_out"])
def test_strided_inverse_is_injective_per_tap(kind):
    """inverse_plan of a strided rulebook: every hit (m, k) appears once, at
    inv[k, idx[k, m]] == m, and nothing else; no input row is claimed twice
    by one tap (the scatter has no collision); padding outputs carry no hit."""
    sb, grid, rb = _level(16)
    out_lin, idx, hit, out_shape = sp.downsample_plan(
        sb, *((3, 2, 1, 1000) if kind == "down" else ((3, 1, 1), (2, 1, 1), 0, 1500)), grid)
    keep = out_lin < int(np.prod(out_shape))
    assert not bool((hit & ~keep[:, None, :]).any())
    inv = tg.inverse_plan(tg.gather_plan(idx, hit, sort=False), sb.features.shape[1]).rulebook
    B, K, M = idx.shape
    for b in range(B):
        for k in range(K):
            m = torch.nonzero(hit[b, k]).flatten()
            src = idx[b, k, m].long()
            assert len(set(src.tolist())) == len(src)  # injective
            assert torch.equal(inv[b, k, src].long(), m)
            assert int((inv[b, k] >= 0).sum()) == len(m)


def test_gather_rows_backward_matches_jax_take_along_axis(monkeypatch):
    """Repeated query pixels (a pixel picked for several classes): their
    gradients add up, as jax.grad of take_along_axis gives; the plain path
    and the Function's index_add_ backward (its launch emulated) agree."""
    rng = np.random.RandomState(0)
    B, HW, C, P = 2, 64, 16, 40
    x = rng.randn(B, HW, C).astype(np.float32)
    pix = rng.randint(0, HW, (B, P))
    pix[:, 20:] = pix[:, :20]
    g = rng.randn(B, P, C).astype(np.float32)
    ref = jax.grad(lambda a: (jnp.take_along_axis(a, jnp.asarray(pix)[..., None], axis=1)
                              * g).sum())(jnp.asarray(x))
    rows = t((pix + np.arange(B)[:, None] * HW).reshape(-1).astype(np.int32))
    xt = t(x).requires_grad_(True)
    (tg.gather_rows(xt, rows).view(B, P, C) * t(g)).sum().backward()
    _close(xt.grad, ref, 1e-6)
    monkeypatch.setattr(tg, "_launch_rows", lambda table, idx: tg.gather_rows_plain(table,
                                                                                    idx).detach())
    xf = t(x).requires_grad_(True)
    (tg._GatherRows.apply(xf, rows).view(B, P, C) * t(g)).sum().backward()
    _close(xf.grad, ref, 1e-6)
