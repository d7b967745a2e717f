"""Port parity: the evaluation's rotated IoU by polygon clipping
(dal3d_tpu_torch/ops/rotated_iou.py) against dal3d_tpu/ops/rotated_iou.py,
BEV and 3D, within 1e-5 absolute: random overlapping sets, identical,
contained, disjoint, edge-touching and zero-area boxes (a union of 0 gives
0), and N across the 128-row block. JAX runs once for all cases (one BEV and
one 3D matrix of the concatenated sets: a pair's value does not depend on
its neighbours), the port once per case.

A zero-area box is held only as a row or against another zero-area box: as
the clipping polygon its four half-planes are degenerate (every point lies
on their edges), both packages keep the whole row box, and the IoU becomes
area / (area - area), a rounding artifact that differs between any two sums.

The NMS's Green's-form IoU (the plain version of the port's K2,
ops/iou_matrix.py) is a different function; on non-degenerate boxes near
the origin the two agree within 1e-5 (the Green's sum cancels terms that
grow with the centres' distance from the origin: at +-5 m it errs by up to
1.7e-5 against a float64 clip, the f32 clip by 9e-7)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.ops import rotated_iou as jri
from dal3d_tpu_torch.ops import iou_matrix as tiou
from dal3d_tpu_torch.ops import rotated_iou as tri
from torch_port_utils import t

ATOL = 1e-5


def _bev(rng, n, spread=5.0, lo=0.5, hi=4.0):
    b = np.zeros((n, 5), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2:4] = rng.uniform(lo, hi, (n, 2))
    b[:, 4] = rng.uniform(-np.pi, np.pi, n)
    return b


def _to_3d(rng, bev):
    b = np.zeros((len(bev), 9), np.float32)
    b[:, :2], b[:, 3:5], b[:, 8] = bev[:, :2], bev[:, 2:4], bev[:, 4]
    b[:, 2] = rng.uniform(-1.0, 1.0, len(b))
    b[:, 5] = rng.uniform(0.5, 2.0, len(b))
    b[:, 6:8] = rng.uniform(-2, 2, (len(b), 2))
    return b


POS = [0, 1, 2, 3, 4, 6, 7]  # the positive-area boxes of _special()
ZERO = [5, 8]


def _special():
    c = float(np.cos(np.pi / 4))
    return np.array([
        [0.0, 0.0, 2.0, 4.0, 0.3],  # 0: a box
        [0.5, 0.5, 1, 1, 0],  # 1: unit square
        [0.5, 0.5, 0.4, 0.4, 0.2],  # 2: contained in 1
        [30.0, -20.0, 2.0, 4.0, 1.0],  # 3: far from all
        [1.5, 0.5, 1, 1, 0],  # 4: abuts 1 (touching edge)
        [0.0, 0.0, 0.0, 0.0, 0.0],  # 5: zero area
        [0.0, 0.0, 1, 1, np.pi / 4],  # 6: rotated
        [c, c, 1, 1, np.pi / 4],  # 7: abuts 6 at a rotated edge
        [0.5, 0.5, 0.0, 0.0, 0.0],  # 8: zero area inside 1
    ], np.float32)


CASES = {
    "random_1x40": lambda rng: (_bev(rng, 1), _bev(rng, 40)),
    "random_129x57": lambda rng: (_bev(rng, 129), _bev(rng, 57)),
    "random_300x64": lambda rng: (_bev(rng, 300), _bev(rng, 64)),
    "thin_and_large": lambda rng: (_bev(rng, 60, 8.0, 0.05, 12.0), _bev(rng, 50, 8.0, 0.05, 12.0)),
    "special": lambda rng: (_special(), _special()[POS]),
    "zero_area": lambda rng: (_special()[ZERO], _special()[ZERO]),
    "identical": lambda rng: (lambda b: (b, b.copy()))(_bev(rng, 130)),
}
NAMES = sorted(CASES)


@pytest.fixture(scope="module")
def sets():
    """Per case: BEV boxes (b1, b2), 3D boxes (B1, B2), and JAX's BEV and 3D
    matrices, cut out of one JAX call each over the concatenated sets."""
    cases = {}
    for k, name in enumerate(NAMES):
        b1, b2 = CASES[name](np.random.RandomState(k))
        rng = np.random.RandomState(100 + k)
        B1 = _to_3d(rng, b1)
        B2 = B1.copy() if name == "identical" else _to_3d(rng, b2)
        cases[name] = [b1, b2, B1, B2]
    r = np.cumsum([0] + [len(cases[n][0]) for n in NAMES])
    c = np.cumsum([0] + [len(cases[n][1]) for n in NAMES])
    cat = [np.concatenate([cases[n][i] for n in NAMES]) for i in range(4)]
    bev = np.asarray(jri.rotated_iou_matrix(jnp.asarray(cat[0]), jnp.asarray(cat[1])))
    iou3d = np.asarray(jri.boxes_iou3d(jnp.asarray(cat[2]), jnp.asarray(cat[3])))
    for k, name in enumerate(NAMES):
        blk = (slice(r[k], r[k + 1]), slice(c[k], c[k + 1]))
        cases[name] += [bev[blk], iou3d[blk]]
    return cases


@pytest.mark.parametrize("name", NAMES)
def test_bev_iou_matches_jax(sets, name):
    b1, b2, _, _, ref, _ = sets[name]
    got = tri.rotated_iou_matrix(t(b1), t(b2)).numpy()
    assert got.shape == ref.shape == (len(b1), len(b2))
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    if name == "identical":
        np.testing.assert_allclose(np.diag(got), 1.0, atol=ATOL)
    if name == "random_129x57":
        assert 0.05 < (got > 0).mean() < 0.9  # a set that overlaps


@pytest.mark.parametrize("name", NAMES)
def test_3d_iou_matches_jax(sets, name):
    _, _, B1, B2, _, ref = sets[name]
    got = tri.boxes_iou3d(t(B1), t(B2)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    if name == "identical":
        np.testing.assert_allclose(np.diag(got), 1.0, atol=ATOL)


def test_special_values():
    b = t(_special())
    got = tri.rotated_iou_matrix(b, b[POS]).numpy()  # columns 0-4: boxes 0-4, 5: 6, 6: 7
    assert got[0, 0] == pytest.approx(1.0, abs=ATOL)
    assert got[1, 2] == pytest.approx(0.16, abs=ATOL)  # contained: area ratio
    assert got[3, :3].max() == 0.0 and got[3, 4:].max() == 0.0  # disjoint
    assert got[1, 4] == pytest.approx(0.0, abs=ATOL)  # touching edge
    assert got[6, 6] == pytest.approx(0.0, abs=ATOL)  # touching rotated edge
    assert got[8, 1] == 0.0  # a zero-area box inside another
    zero = tri.rotated_iou_matrix(b[ZERO], b[ZERO]).numpy()
    assert (zero == 0.0).all()  # union 0 gives 0


def test_block_size_changes_no_value():
    rng = np.random.RandomState(3)
    b1, b2 = t(_bev(rng, 300)), t(_bev(rng, 70))
    ref = tri.rotated_iou_matrix(b1, b2)
    for block in (1, 7, 128, 512):
        assert torch.equal(tri.rotated_iou_matrix(b1, b2, block=block), ref)
    assert tri.rotated_iou_matrix(b1[:0], b2).shape == (0, 70)


def test_greens_plain_agrees_with_the_clip_on_non_degenerate_boxes():
    """K2's plain version (the NMS's IoU) and the eval's polygon clip, on
    positive-area boxes within +-2 m of the origin."""
    rng = np.random.RandomState(4)
    b1, b2 = _bev(rng, 200, spread=2.0), _bev(rng, 150, spread=2.0)
    clip = tri.rotated_iou_matrix(t(b1), t(b2)).numpy()
    greens = tiou.iou_matrix_plain(tiou._pack_rowdat(t(b1)[None]),
                                   tiou._pack_rowdat(t(b2)[None]))[0].numpy()
    assert 0.05 < (clip > 0).mean() < 0.95
    np.testing.assert_allclose(greens, clip, atol=ATOL, rtol=0)


def test_far_from_the_origin_the_port_keeps_its_accuracy():
    """The port clips each pair in a frame centred on its first box: moving
    a scene 45 m from the origin changes its IoUs by float rounding of the
    centres alone, and a float64 run agrees within 1e-6 (JAX's clip of
    absolute corners rounds terms of |x|^2 there, ~1e-4)."""
    rng = np.random.RandomState(5)
    b1, b2 = _bev(rng, 100), _bev(rng, 80)
    near = tri.rotated_iou_matrix(t(b1), t(b2))
    shift = np.array([45.0, -45.0, 0, 0, 0], np.float32)
    far = tri.rotated_iou_matrix(t(b1 + shift), t(b2 + shift))
    far64 = tri.rotated_iou_matrix(t(b1 + shift).double(), t(b2 + shift).double())
    assert (near > 0).float().mean() > 0.05
    np.testing.assert_allclose(far.numpy(), near.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(far.double().numpy(), far64.numpy(), atol=1e-6, rtol=0)
