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

