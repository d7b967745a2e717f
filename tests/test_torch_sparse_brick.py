"""Port parity: the banded brick engine (dal3d_tpu_torch/ops/sparse_brick.py)
against dal3d_tpu/ops/sparse_brick.py.

Integer plans (brick pack, subm rulebooks, downsample outputs and rulebooks)
must be bit-identical to JAX's host plan pyramid
(data/sparse_plans.py::_pyramid_plan) on the same voxels, including a scene
whose capacities overflow. Feature outputs of the banded subm and strided
convs are held to JAX's band-plan versions in f32 (atol 1e-4: summation
order), with JAX's fallback covering every out-of-band entry."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.data.sparse_plans import DOWNSAMPLE_SPECS, _pyramid_plan
from dal3d_tpu.ops import sparse_brick as spb
from dal3d_tpu_torch.ops import sparse_brick as tsb
from test_sparse_brick import _random_scene
from torch_port_utils import t

SHAPE = (41, 64, 64)
WIDTHS = (8, 8, 8, 4, 4)


@pytest.mark.parametrize("caps", [(1536, 1536, 768, 384, 384),  # roomy
                                  (128, 256, 128, 64, 64)])  # every level overflows
def test_plan_pyramid_bit_identical(caps):
    rng = np.random.RandomState(0)
    _, coords, valid = _random_scene(rng, B=2, N=400, shape=SHAPE, C=5)
    coords = np.asarray(coords, np.int32)
    valid = np.asarray(valid)
    ref = jax.jit(lambda c, v: _pyramid_plan(c, v, shape=SHAPE, widths=WIDTHS, caps=caps,
                                             spatial=True))(coords, valid)
    ref = {k: np.asarray(v) for k, v in ref.items()}

    lin, row = tsb.pack_plan_arrays(t(coords), t(valid), SHAPE, WIDTHS[0], caps[0])
    np.testing.assert_array_equal(lin.numpy(), ref["brick_lin"])
    np.testing.assert_array_equal(row.numpy(), ref["brick_row"])
    bb = tsb.BrickBatch(features=torch.zeros(2, caps[0], WIDTHS[0]), brick_lin=lin,
                        vmask=torch.zeros(2, caps[0], WIDTHS[0], dtype=torch.bool),
                        shape=SHAPE, bw=WIDTHS[0])
    for i, (k, s, p) in enumerate(DOWNSAMPLE_SPECS):
        grid = tsb.build_brick_grid(bb)
        np.testing.assert_array_equal(tsb.subm_rulebook(bb, 3, grid).numpy(), ref[f"rb{i}"])
        out_lin, idx, out_shape, _, _ = tsb.downsample_plan(bb, k, s, p, WIDTHS[i + 1],
                                                            caps[i + 1], grid)
        np.testing.assert_array_equal(out_lin.numpy(), ref[f"ds{i + 1}_lin"])
        np.testing.assert_array_equal(idx.numpy(), ref[f"ds{i + 1}_idx"])
        bb = tsb.BrickBatch(features=torch.zeros(2, caps[i + 1], WIDTHS[i + 1]),
                            brick_lin=out_lin, vmask=None, shape=out_shape, bw=WIDTHS[i + 1])
    if caps[1] < 1536:  # the overflow scene really drops bricks
        assert (ref["brick_row"][np.asarray(valid)] < 0).any()


def _scene(bw, seed, C=4):
    rng = np.random.RandomState(seed)
    shape = (6, 16, 32)
    feats, coords, valid = _random_scene(rng, shape=shape, C=C)
    jb = spb.from_voxels(feats, coords, valid, shape, bw=bw, mb_cap=384, spatial=True)
    tb = tsb.from_voxels(t(feats), t(coords), t(valid), shape, bw=bw, mb_cap=384)
    np.testing.assert_array_equal(tb.brick_lin.numpy(), np.asarray(jb.brick_lin))
    np.testing.assert_array_equal(tb.vmask.numpy(), np.asarray(jb.vmask))
    np.testing.assert_array_equal(tb.features.numpy(), np.asarray(jb.features))
    np.testing.assert_array_equal(tsb.to_dense(tb).numpy(), np.asarray(spb.to_dense(jb)))
    return rng, jb, tb


@pytest.mark.parametrize("bw", [4, 8])
def test_subm_conv_matches_jax(bw):
    rng, jb, tb = _scene(bw, seed=5)
    w = (rng.randn(27, 4, 6) * 0.2).astype(np.float32)
    jrb = spb.subm_rulebook_banded(jb, 3, band=128, fb_cap=512)
    for plan in (jrb.conv_plan, jrb.pad_plan):
        np.testing.assert_array_equal(np.asarray(plan.fb_covered), np.asarray(plan.oob_count))
    ref = spb.subm_conv(jb, jnp.asarray(w), rulebook=jrb)
    got = tsb.subm_conv(tb, t(w), tsb.subm_rulebook_banded(tb, 3))
    np.testing.assert_allclose(got.features.numpy(), np.asarray(ref.features),
                               rtol=1e-4, atol=1e-4)


def test_downsample_conv_matches_jax():
    rng, jb, tb = _scene(4, seed=6)
    w = (rng.randn(27, 4, 6) * 0.2).astype(np.float32)
    ref = spb.downsample_conv_banded(jb, jnp.asarray(w), (3, 3, 3), (2, 2, 2), (1, 1, 1),
                                     out_bw=4, out_cap=256, band=128, fb_cap=1024)
    got = tsb.downsample_conv_banded(tb, t(w), (3, 3, 3), (2, 2, 2), (1, 1, 1),
                                     out_bw=4, out_cap=256)
    assert got.shape == ref.shape and got.bw == ref.bw
    np.testing.assert_array_equal(got.brick_lin.numpy(), np.asarray(ref.brick_lin))
    np.testing.assert_array_equal(got.vmask.numpy(), np.asarray(ref.vmask))
    np.testing.assert_allclose(got.features.numpy(), np.asarray(ref.features),
                               rtol=1e-4, atol=1e-4)
