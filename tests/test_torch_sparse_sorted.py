"""Port parity of the searchsorted sparse engine (dal3d_tpu_torch/ops/sparse.py:
JAX's sorted-order oracle) against ``dal3d_tpu/ops/sparse.py`` on the CPU,
at ``torch_port_utils.small_voxels`` sizes (sparse shape (41, 64, 64), B=2).

Required: ``from_voxels``' row order, the submanifold rulebooks (idx of
misses included) and every downsample plan, chained level by level with one
level overflowing its cap in one frame, bit-equal to JAX's; the grid
engine's rulebooks and output sets equal to the sorted engine's as sets
(each output cell's list of input cells), where no cap drops; the gather
backbone's modules on the sorted plans (``scn.sorted_forward``) giving the
gather engine's maps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.ops import sparse as jss
from dal3d_tpu_torch.models.backbones.scn import FPNSpMiddleResNetFHD, sorted_forward
from dal3d_tpu_torch.models.builder import build_detector
from dal3d_tpu_torch.ops import sparse as ss
from dal3d_tpu_torch.ops import sparse_grid as spg
from test_torch_camera_branch import few_threads  # noqa: F401
from torch_port_utils import small_gather_cfg, small_voxels, t

pytestmark = pytest.mark.usefixtures("few_threads")

SHAPE = (41, 64, 64)
DOWNS = (((3, 3, 3), (2, 2, 2), (1, 1, 1)), ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
         ((3, 3, 3), (2, 2, 2), (0, 1, 1)), ((3, 1, 1), (2, 1, 1), (0, 0, 0)))
CAPS = (1920, 1536, 384, 128)  # the first overflows in one frame, the last fills
WIDE = (6000, 6000, 6000, 6000)


def _chain(mod, caps, vf, vc, vv):
    """Every level's (rulebook, downsample plan) of ``mod`` (either package's
    sorted engine), chained from the voxels."""
    sb = mod.from_voxels(vf, vc, vv, SHAPE)
    out = [sb]
    for cap, (k, s, p) in zip(caps, DOWNS):
        rb = mod.subm_rulebook(sb, 3)
        down = mod.downsample_plan(sb, k, s, p, cap)
        out.append((rb, down))
        sb = mod.SparseBatch(features=out[0].features[:, :1, :1] * 0, lin=down[0],
                             shape=down[3])
    return out


def test_from_voxels_rulebooks_and_plans_bit_equal():
    vox = small_voxels(0)
    j = jax.jit(lambda *a: _chain(jss, CAPS, *a))(*(jnp.asarray(a) for a in vox))
    p = _chain(ss, CAPS, *(t(a) for a in vox))
    np.testing.assert_array_equal(p[0].lin.numpy(), np.array(j[0].lin))
    np.testing.assert_array_equal(p[0].features.numpy(), np.array(j[0].features))
    assert p[0].lin.dtype == torch.int32
    full = []
    for (jrb, jd), (rb, d) in zip(j[1:], p[1:]):
        for got, want in zip(rb, jrb):
            np.testing.assert_array_equal(got.numpy(), np.array(want))
        for got, want in zip(d[:3], jd[:3]):
            np.testing.assert_array_equal(got.numpy(), np.array(want))
        assert d[3] == jd[3]
        full.append(int((d[0] < np.prod(d[3])).sum(-1).max()))
    assert full[0] == CAPS[0] and full[-1] == CAPS[-1]


def _as_sets(sb_lin, idx, hit, in_lin, n_out):
    """{(frame, output cell): sorted tuple of (tap, input cell)} of a plan."""
    out = {}
    lin, idx, hit, in_lin = (x.numpy() for x in (sb_lin, idx, hit, in_lin))
    for b in range(lin.shape[0]):
        for m in np.nonzero(lin[b] < n_out)[0]:
            taps = np.nonzero(hit[b, :, m])[0]
            out[(b, int(lin[b, m]))] = tuple((int(q), int(in_lin[b, idx[b, q, m]]))
                                             for q in taps)
    return out


def test_grid_plans_equal_sorted_plans_as_sets():
    vf, vc, vv = small_voxels(0)
    srt = ss.from_voxels(t(vf), t(vc), t(vv), SHAPE)
    grd = spg.from_voxels(t(vf), t(vc), t(vv), SHAPE)
    assert not torch.equal(srt.lin, grd.lin)  # the grid engine keeps the voxel order
    for cap, (k, s, p) in zip(WIDE, DOWNS):
        n_in = int(np.prod(srt.shape))
        want = _as_sets(srt.lin, *ss.subm_rulebook(srt, 3), srt.lin, n_in)
        got = _as_sets(grd.lin, *spg.subm_rulebook(grd, 3), grd.lin, n_in)
        assert got == want and len(got) > 0
        sd, gd = ss.downsample_plan(srt, k, s, p, cap), spg.downsample_plan(grd, k, s, p, cap)
        n_out = int(np.prod(sd[3]))
        assert int((sd[0] < n_out).sum(-1).max()) < cap  # no cap drops here
        assert _as_sets(gd[0], gd[1], gd[2], grd.lin, n_out) == \
            _as_sets(sd[0], sd[1], sd[2], srt.lin, n_out)
        srt = ss.SparseBatch(features=srt.features[:, :, :1], lin=sd[0], shape=sd[3])
        grd = spg.SparseBatch(features=grd.features[:, :, :1], lin=gd[0], shape=gd[3])


def test_gather_backbone_on_sorted_plans():
    vf, vc, vv = small_voxels(0)
    model = build_detector(small_gather_cfg(WIDE), device="cpu", seed=3).model
    with torch.inference_mode():
        want, wmid = model.backbone(t(vf), t(vc), t(vv))
        got, gmid = sorted_forward(model.backbone, t(vf), t(vc), t(vv))
    scale = float(want.abs().max())
    assert scale > 0 and float((got - want).abs().max()) <= 1e-6 * scale
    for g, w in zip(gmid, wmid):
        assert torch.equal(torch.sort(g.lin, -1)[0], torch.sort(w.lin, -1)[0])
        assert float((ss.to_dense(g) - ss.to_dense(w)).abs().max()) <= 1e-6 * scale
    with pytest.raises(ValueError, match="gather backbone"):
        sorted_forward(FPNSpMiddleResNetFHD(SHAPE, impl="dense"), t(vf), t(vc), t(vv))
