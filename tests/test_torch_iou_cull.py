"""CPU tests of the cull of the rotated-IoU kernel (K2,
dal3d_tpu_torch/ops/csrc/iou_matrix.cu), where the CUDA kernel cannot run.

The kernel writes +0.0 without the clip for every pair that
ops/iou_matrix.py::iou_cull_plain (the plain twin of its predicate) culls:
two boxes whose circumscribed discs lie apart by the margin, or a box of
zero area. That is exact only if iou_matrix_plain gives +0.0 on every such
pair, eps branches of the clip included. Shown here on random and clustered
sets, on adversarial pairs placed just beyond the cull distance (corners
facing each other, parallel and perpendicular edges, thin boxes), on zero
records and at coordinates up to 1e3 m. A plain replay of the kernel
(+0.0 where culled, the plain value elsewhere) is then bit-equal to
iou_matrix_plain. Records that are not finite are never culled.

Of one record set against itself the kernel clips a pair once and writes it
at both places: iou_matrix_plain(r, r) and the cull are bit-symmetric."""
import numpy as np
import pytest
import torch

from dal3d_tpu_torch.ops import iou_matrix as tiou
from torch_port_utils import t


def boxes(rng, shape, extent=50.0, lo=0.4, hi=12.0):
    b = np.zeros((*shape, 5), np.float32)
    b[..., :2] = rng.uniform(-extent, extent, (*shape, 2))
    b[..., 2:4] = rng.uniform(lo, hi, (*shape, 2))
    b[..., 4] = rng.uniform(-np.pi, np.pi, shape)
    return b


def clustered(rng, G, N, centres=12):
    """NMS-like candidates: a few objects, each with many jittered copies."""
    b = boxes(rng, (G, centres), lo=0.5, hi=6.0)
    pick = rng.randint(0, centres, (G, N))
    out = np.take_along_axis(b, pick[..., None], axis=1).copy()
    out[..., :2] += rng.normal(0, 0.6, (G, N, 2))
    out[..., 2:4] *= rng.uniform(0.8, 1.25, (G, N, 2))
    out[..., 4] += rng.normal(0, 0.2, (G, N))
    return out.astype(np.float32)


def replay(rows, cols):
    """The kernel's result in plain arithmetic: +0.0 where culled, the plain
    value elsewhere; and the cull mask."""
    cull = tiou.iou_cull_plain(rows, cols)
    return torch.where(cull, torch.zeros(()), tiou.iou_matrix_plain(rows, cols)), cull


def assert_exact_zeros(rows, cols):
    """On every culled pair the plain version is +0.0 (bits 0), so the
    replay is bit-equal to it. Returns the cull mask."""
    plain = tiou.iou_matrix_plain(rows, cols)
    got, cull = replay(rows, cols)
    bits = plain.view(torch.int32)
    bad = cull & (bits != 0)
    assert not bool(bad.any()), (int(bad.sum()), plain[bad][:8])
    assert torch.equal(got.view(torch.int32), bits)
    return cull


def pair_records(b1, b2):
    """Per-pair records [P, 1, 32] x [P, 1, 32] (one pair a group)."""
    return tiou._pack_rowdat(t(b1)[:, None]), tiou._pack_rowdat(t(b2)[:, None])


def adversarial_pairs(rng, P, offset, lo=0.4, hi=12.0, thin=False, mode="random"):
    """Pairs placed with their centres at the cull distance (the reaches and
    the margin) times (1 + delta) apart, delta in +-5e-3 (about half of them
    culled, half just inside), in random
    directions. mode "corner": a corner of each box points at the other
    box's centre (the boxes' nearest points lie on the centre line);
    "parallel": both boxes share a yaw of 0 or a multiple of pi/2 and face
    each other edge to edge along an axis; "random": random yaws."""
    b1, b2 = boxes(rng, (P,), lo=lo, hi=hi), boxes(rng, (P,), lo=lo, hi=hi)
    if thin:
        b1[:, 2], b2[:, 3] = 0.01, 0.01
    theta = rng.uniform(-np.pi, np.pi, P).astype(np.float32)
    if mode == "parallel":
        theta = (rng.randint(0, 4, P) * (np.pi / 2)).astype(np.float32)
        b1[:, 4] = rng.randint(0, 4, P) * (np.pi / 2)
        b2[:, 4] = b1[:, 4]
    elif mode == "corner":
        # corners_2d turns the box by -yaw: corner 0 sits at atan2(-l/2, -w/2) - yaw
        b1[:, 4] = np.arctan2(-b1[:, 3] / 2, -b1[:, 2] / 2) - theta
        b2[:, 4] = np.arctan2(-b2[:, 3] / 2, -b2[:, 2] / 2) - (theta + np.pi)
    r1 = 0.5 * np.hypot(b1[:, 2], b1[:, 3])
    r2 = 0.5 * np.hypot(b2[:, 2], b2[:, 3])
    delta = rng.uniform(-5e-3, 5e-3, P)
    b1[:, :2] = offset + rng.uniform(-20, 20, (P, 2))
    far = np.abs(b1[:, 0]) + np.abs(b1[:, 1])  # about that of both centres
    dist = (r1 + r2 + tiou._CULL_REL * (2 * far + r1 + r2) + tiou._CULL_MARGIN) * (1.0 + delta)
    b2[:, 0] = b1[:, 0] + dist * np.cos(theta)
    b2[:, 1] = b1[:, 1] + dist * np.sin(theta)
    return b1.astype(np.float32), b2.astype(np.float32)


def test_random_and_clustered_sets():
    rng = np.random.RandomState(0)
    sets = [boxes(rng, (2, 1000)), clustered(rng, 2, 600), boxes(rng, (2, 400), extent=8.0)]
    shares = []
    for b in sets:
        rec = tiou._pack_rowdat(t(b))
        cull = assert_exact_zeros(rec, rec)
        shares.append(1.0 - float(cull.float().mean()))
    # the synthetic set keeps a few percent; crowded sets keep more
    assert shares[0] < 0.05 and shares[1] > shares[0] and shares[2] > shares[0], shares


@pytest.mark.parametrize("mode", ["random", "corner", "parallel"])
@pytest.mark.parametrize("offset", [0.0, 250.0, -1000.0])
def test_adversarial_pairs_at_the_cull_distance(mode, offset):
    rng = np.random.RandomState(int(abs(offset)) + len(mode))
    for thin in (False, True):
        b1, b2 = adversarial_pairs(rng, 4000, np.float32(offset), thin=thin, mode=mode)
        r1, r2 = pair_records(b1, b2)
        cull = assert_exact_zeros(r1, r2)
        # the placement straddles the cull distance: both sides are exercised
        assert 0.2 < float(cull.float().mean()) < 0.8
        assert_exact_zeros(r2, r1)


def test_thin_boxes_and_parallel_edges_in_a_row():
    """Thin 0.01 x 12 m boxes side by side, parallel, spaced just beyond and
    just within the cull distance, and square boxes edge to edge."""
    n = 200
    b = np.zeros((1, n, 5), np.float32)
    r = 0.5 * np.hypot(0.01, 12.0)
    step = 2 * r + tiou._CULL_MARGIN
    b[0, :, 0] = np.arange(n) * step * 1.001 - 100.0
    b[0, :, 2], b[0, :, 3] = 0.01, 12.0
    b[0, n // 2:, 4] = np.pi / 2
    sq = np.zeros((1, n, 5), np.float32)
    # at 700-1000 m the reaches widen by about 1 cm each
    sq[0, :, 0] = np.arange(n) * (np.sqrt(2.0) + tiou._CULL_MARGIN + 0.03) + 700.0
    sq[0, :, 1] = -300.0
    sq[0, :, 2:4] = 1.0
    for rec in (tiou._pack_rowdat(t(b)), tiou._pack_rowdat(t(sq))):
        cull = assert_exact_zeros(rec, rec)
        assert bool(cull[0, 0, 1]) and not bool(cull[0, 0, 0])


def test_zero_records_are_culled_and_exact():
    rng = np.random.RandomState(3)
    b = boxes(rng, (2, 300))
    b[:, 250:] = 0.0  # padding slots of the batched NMS
    b[:, 10, 2] = 0.0  # a box of zero width, not at the origin
    rec = tiou._pack_rowdat(t(b))
    cull = assert_exact_zeros(rec, rec)
    assert bool(cull[:, 250:].all()) and bool(cull[:, :, 250:].all()) and bool(cull[:, 10].all())


def test_nonfinite_records_are_never_culled():
    rng = np.random.RandomState(4)
    b = boxes(rng, (1, 64))
    b[0, 0, 0] = np.nan
    b[0, 1, 1] = np.inf
    b[0, 2, 3] = -np.inf
    b[0, 3] = 0.0  # zero area, but paired with the records above
    rec = tiou._pack_rowdat(t(b))
    rec[0, 4, 17] = float("nan")  # a plane lane alone
    rec[0, 5, 28] = float("inf")  # the area lane alone
    cull = tiou.iou_cull_plain(rec, rec)
    for k in (0, 1, 2, 4, 5):
        assert not bool(cull[0, k].any()) and not bool(cull[0, :, k].any()), k
    assert bool(cull[0, 3, 6:].all())
    # the culled pairs among the rest are still exact
    assert_exact_zeros(rec[:, 6:], rec[:, 6:])


def test_far_coordinates_keep_the_cull():
    """At 1e3 m the reach widens by about 2 cm; the synthetic set shifted
    there still culls nearly as much, and exactly."""
    rng = np.random.RandomState(5)
    b = boxes(rng, (1, 800))
    base = tiou._pack_rowdat(t(b))
    b[..., :2] += np.float32(1000.0)
    far = tiou._pack_rowdat(t(b))
    c0 = tiou.iou_cull_plain(base, base)
    c1 = assert_exact_zeros(far, far)
    assert float(c1.float().mean()) > float(c0.float().mean()) - 0.01


def test_one_set_against_itself_is_bit_symmetric():
    """The kernel's mirror route: the plain result and the cull of a set
    against itself equal their transposes bit for bit, on uniform,
    clustered, coincident-edge and far-off sets."""
    rng = np.random.RandomState(6)
    far = boxes(rng, (1, 300))
    far[..., :2] += np.float32(-1000.0)
    edge = np.array([[[0.5, 0.5, 1, 1, 0], [1.5, 0.5, 1, 1, 0], [1.0, 0.5, 1, 1, 0],
                      [1.0, 0.5, 2, 1, 0], [0.0, 0.0, 1, 1, np.pi / 4],
                      [np.cos(np.pi / 4), np.cos(np.pi / 4), 1, 1, np.pi / 4],
                      [0.0, 0.0, 0.0, 0.0, 0.0]]], np.float32)
    for b in (boxes(rng, (2, 500)), clustered(rng, 2, 500), far, edge):
        rec = tiou._pack_rowdat(t(b))
        plain = tiou.iou_matrix_plain(rec, rec).view(torch.int32)
        assert torch.equal(plain, plain.transpose(1, 2))
        cull = tiou.iou_cull_plain(rec, rec)
        assert torch.equal(cull, cull.transpose(1, 2))


def test_a_smaller_margin_is_caught(monkeypatch):
    """The adversarial pairs have the power to reject a margin that is too
    small: at -1 cm the plain version is nonzero on culled pairs with a
    corner facing the other box."""
    monkeypatch.setattr(tiou, "_CULL_MARGIN", -0.01)
    rng = np.random.RandomState(7)
    bad = 0
    for thin in (False, True):
        b1, b2 = adversarial_pairs(rng, 4000, np.float32(0.0), thin=thin, mode="corner")
        r1, r2 = pair_records(b1, b2)
        plain = tiou.iou_matrix_plain(r1, r2).view(torch.int32)
        bad += int((tiou.iou_cull_plain(r1, r2) & (plain != 0)).sum())
    assert bad > 0
