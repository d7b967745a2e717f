"""Port parity: rotated-IoU records + matrix (dal3d_tpu_torch/ops/iou_matrix.py)
and greedy NMS (ops/nms.py) against dal3d_tpu/ops/pallas_iou.py and
dal3d_tpu/ops/nms.py, on the cases of tests/test_pallas_iou.py.

The port's plain version repeats the Pallas kernel's arithmetic, so on the
same records it is held to the interpret-mode kernel at atol 1e-5, except
where boxes sit tens of meters from the origin: there the Green's sum
cancels cross terms of ~1e3 m^2, f32 rounding alone moves an IoU by a few
1e-5 (against a float64 evaluation of the same formula the XLA run errs by
up to 2.5e-5 and the port by 4.7e-5), and the bound is 1e-4. Against the
XLA Green's path it is held at atol 1e-3, as tests/test_pallas_iou.py holds
the kernel."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.ops.nms import greedy_nms_from_iou as jax_nms
from dal3d_tpu.ops.pallas_iou import _iou_pallas, _pack_rowdat
from dal3d_tpu.ops.rotated_iou_fast import rotated_iou_matrix_greens
from dal3d_tpu_torch.ops import iou_matrix as tiou
from dal3d_tpu_torch.ops.nms import greedy_nms_from_iou
from torch_port_utils import t


def _random_boxes(rng, n):
    b = np.zeros((n, 5), np.float32)
    b[:, 0:2] = rng.uniform(-40, 40, (n, 2))
    b[:, 2:4] = rng.uniform(0.5, 6.0, (n, 2))
    b[:, 4] = rng.uniform(-np.pi, np.pi, n)
    return b


def _cases():
    rng = np.random.RandomState(0)
    random = (np.stack([_random_boxes(rng, 130) for _ in range(3)]),
              np.stack([_random_boxes(rng, 57) for _ in range(3)]))
    special = np.array([
        [0.0, 0.0, 2.0, 4.0, 0.3],
        [0.0, 0.0, 2.0, 4.0, 0.3],  # identical -> 1
        [50.0, 50.0, 2.0, 4.0, 1.0],  # far away -> 0
        [0.0, 0.0, 0.0, 0.0, 0.0],  # degenerate pad slot -> 0
    ], np.float32)[None]
    rng = np.random.RandomState(7)
    dup = np.zeros((96, 5), np.float32)
    dup[:, 0:2] = rng.uniform(-50, 50, (96, 2))
    dup[:, 2:4] = rng.uniform(0.3, 8.0, (96, 2))
    dup[:, 4] = rng.uniform(-np.pi, np.pi, 96)
    dup[48:] = dup[:48]  # exact duplicates at far centers
    c = float(np.cos(np.pi / 4))
    coincident = np.array([
        [0.5, 0.5, 1, 1, 0], [1.5, 0.5, 1, 1, 0],  # abutting -> 0
        [0.5, 0.5, 1, 1, 0], [1.0, 0.5, 1, 1, 0],  # shared collinear edges -> 1/3
        [1.0, 0.5, 2, 1, 0], [0.5, 0.5, 1, 1, 0],  # contained, shares an edge -> 1/2
        [0.0, 0.0, 1, 1, np.pi / 4], [c, c, 1, 1, np.pi / 4],  # rotated abutting -> 0
    ], np.float32)[None]
    return {"random": random, "special": (special, special), "duplicates": (dup[None], dup[None]),
            "coincident": (coincident, coincident)}


CASES = _cases()
# per-case bound against the interpret-mode kernel (see the module docstring)
KERNEL_ATOL = {"random": 1e-4, "duplicates": 1e-4, "special": 1e-5, "coincident": 1e-5}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas_kernel_and_greens(name):
    b1, b2 = CASES[name]
    rows_j = _pack_rowdat(jnp.asarray(b1))
    cols_j = _pack_rowdat(jnp.asarray(b2))
    rows, cols = tiou._pack_rowdat(t(b1)), tiou._pack_rowdat(t(b2))
    np.testing.assert_allclose(rows.numpy(), np.asarray(rows_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(cols.numpy(), np.asarray(cols_j), rtol=1e-5, atol=1e-5)
    # the kernel arithmetic, on JAX's own records: the Pallas kernel wants
    # 128-multiples; zero boxes pad (IoU 0) and are cut off
    pn, pm = (-b1.shape[1]) % 128, (-b2.shape[1]) % 128
    rp = jnp.pad(rows_j, ((0, 0), (0, pn), (0, 0)))
    cp = jnp.swapaxes(jnp.pad(cols_j, ((0, 0), (0, pm), (0, 0))), 1, 2)
    ref = np.asarray(_iou_pallas(rp, cp, interpret=True))[:, :b1.shape[1], :b2.shape[1]]
    same_rec = tiou.iou_matrix_plain(t(rows_j), t(cols_j)).numpy()
    np.testing.assert_allclose(same_rec, ref, atol=KERNEL_ATOL[name])
    # the whole port path, on its own records
    got = tiou.iou_matrix_plain(rows, cols).numpy()
    np.testing.assert_allclose(got, ref, atol=KERNEL_ATOL[name])
    greens = np.asarray(jax.vmap(rotated_iou_matrix_greens)(jnp.asarray(b1), jnp.asarray(b2)))
    np.testing.assert_allclose(got, greens, atol=1e-3)
    assert got.min() >= 0.0 and got.max() <= 1.0 + 1e-4


def test_coincident_edge_values():
    b = t(CASES["coincident"][0][0])
    got = tiou.rotated_iou_matrix_batched(b[0::2][:, None], b[1::2][:, None])[:, 0, 0]
    np.testing.assert_allclose(got.numpy(), [0.0, 1.0 / 3.0, 0.5, 0.0], atol=1e-3)


def _long_duplicates(lo, hi, n=128):
    """Thin boxes (0.1-3 m wide) from lo to hi m long, each twice (n a
    multiple of 128, as the Pallas kernel wants)."""
    rng = np.random.RandomState(0)
    b = np.zeros((n, 5), np.float32)
    b[:, :2] = rng.uniform(-80, 80, (n, 2))
    b[:, 2] = rng.uniform(0.1, 3.0, n)
    b[:, 3] = np.exp(rng.uniform(np.log(lo), np.log(hi), n))
    b[:, 4] = rng.uniform(-np.pi, np.pi, n)
    b[n // 2:] = b[:n // 2]
    return b


@pytest.mark.parametrize("lengths", [(20.0, 1000.0), (2000.0, 8000.0)])
def test_long_duplicates(lengths):
    """The kernel's arithmetic on duplicates of long thin boxes, against
    the exact IoU (the sorting engine in f64). Up to a km, JAX's kernel and
    the port agree with each other and with the exact IoU within 5e-4 (the
    Green's sum cancels cross terms of up to 1e6 m^2 in f32). From 2 km on,
    the f32 rounding of an edge's projection on its twin's normal (|d| x
    2^-24, over 1e-4 m) leaves the 1e-4 m parallel / on-boundary band, so a
    duplicate's IoU (exactly 1) falls to 1/3 or below in JAX's kernel and in
    the port alike, each on its own pairs: JAX's arithmetic, kept."""
    from dal3d_tpu_torch.ops.rotated_iou_fast import rotated_iou_matrix_fast

    b = _long_duplicates(*lengths)
    rows_j = _pack_rowdat(jnp.asarray(b[None]))
    ref = np.asarray(_iou_pallas(rows_j, jnp.swapaxes(rows_j, 1, 2), interpret=True))[0]
    got = tiou.iou_matrix_plain(*(tiou._pack_rowdat(t(b[None])),) * 2)[0].numpy()
    exact = rotated_iou_matrix_fast(t(b).double(), t(b).double()).numpy()
    i = np.arange(len(b) // 2)
    np.testing.assert_allclose(exact[i, i + len(i)], 1.0, atol=1e-9)
    for m in (ref, got):
        assert m.min() >= 0.0 and m.max() <= 1.0 + 1e-4
        if lengths[1] <= 1000.0:
            np.testing.assert_allclose(m, exact, atol=5e-4)
        else:
            assert np.abs(m[i, i + len(i)] - 1.0).max() > 0.5
    if lengths[1] <= 1000.0:
        np.testing.assert_allclose(got, ref, atol=5e-4)


def test_self_iou_of_km_long_predict_candidates():
    """The 44 boxes of 1.0-7.2 km among the head's candidates of one
    full-width predict with untrained weights
    (``tests/fixtures/predict_candidates.npz``, set 0), each against
    itself (exactly 1): the f32 routes each lose a few, on boxes of their
    own. JAX's kernel 3 under 0.99 (down to 0.579), JAX's Green's matrix 2
    (0.333), the port's K2 arithmetic 1 (0.333); the port's Green's matrix,
    its corners rounded from f64, keeps every one at 0.9985 or more."""
    import os

    from dal3d_tpu_torch.ops.rotated_iou_fast import (rotated_iou_matrix_fast,
                                                      rotated_iou_matrix_greens as t_greens)

    b = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                             "predict_candidates.npz"))["bev"][0]
    b = b[np.abs(b[:, 2:4]).max(1) >= 1000.0]
    assert len(b) == 44
    pad = np.zeros((128, 5), np.float32)
    pad[:len(b)] = b
    rows_j = _pack_rowdat(jnp.asarray(pad[None]))
    diag = {
        "exact": rotated_iou_matrix_fast(t(b).double(), t(b).double()).numpy(),
        "jax_kernel": np.asarray(_iou_pallas(rows_j, jnp.swapaxes(rows_j, 1, 2),
                                             interpret=True))[0][:len(b), :len(b)],
        "jax_greens": np.asarray(rotated_iou_matrix_greens(jnp.asarray(b), jnp.asarray(b))),
        "k2": tiou.iou_matrix_plain(*(tiou._pack_rowdat(t(b[None])),) * 2)[0].numpy(),
        "port_greens": t_greens(t(b), t(b)).numpy(),
    }
    diag = {k: np.diagonal(m) for k, m in diag.items()}
    np.testing.assert_allclose(diag["exact"], 1.0, atol=1e-9)
    lost = {k: int((d < 0.99).sum()) for k, d in diag.items()}
    assert lost == dict(exact=0, jax_kernel=3, jax_greens=2, k2=1, port_greens=0), lost
    assert diag["port_greens"].min() >= 0.9985
    for k, low in (("jax_kernel", 0.58), ("jax_greens", 0.34), ("k2", 0.34)):
        assert diag[k].min() < low, (k, diag[k].min())
    # each route loses boxes of its own
    assert not np.array_equal(diag["k2"] < 0.99, diag["jax_kernel"] < 0.99)


@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_nms_keep_masks_equal(seed):
    rng = np.random.RandomState(seed)
    G, N = 3, 200
    boxes = np.stack([_random_boxes(rng, N) for _ in range(G)])
    boxes[:, :, :2] *= 0.1  # crowd the boxes so suppression chains form
    iou = np.asarray(jax.vmap(rotated_iou_matrix_greens)(jnp.asarray(boxes), jnp.asarray(boxes)))
    valid = rng.rand(G, N) > 0.1
    ref = np.asarray(jax.vmap(lambda i, v: jax_nms(i, v, 0.2))(jnp.asarray(iou), jnp.asarray(valid)))
    got = greedy_nms_from_iou(t(iou), t(valid), 0.2).numpy()
    assert 0 < ref.sum() < valid.sum()  # suppression happened
    np.testing.assert_array_equal(got, ref)

