"""PointPillars and the image FPN of the PyTorch port against the JAX
package on the CPU: ``pillarize`` bit for bit (in-grid test, the pillar cap,
ascending cell order, invalid and non-finite points), the PillarFeatureNet
(eval and train mode, its running statistics), the BEV scatter, the whole
detector at the width of JAX's own test (tests/test_extras.py:49-64) and
``FPN`` (a non-integer resize), each on weights carried across by
``models/convert_flax.py``, within 1e-4 of scale in f32. JAX's side is one
jitted function, run once for the file: weights from ``jax.eval_shape``,
drawn with numpy."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.models.detectors.point_pillars import PointPillars as JPointPillars
from dal3d_tpu.models.necks.fpn import FPN as JFPN
from dal3d_tpu.models.readers.pillar_encoder import (PillarFeatureNet as JPFN,
                                                      PointPillarsScatter as JScatter,
                                                      pillarize as jpillarize)
from dal3d_tpu.ops.voxelize import VoxelConfig as JVoxelConfig
from dal3d_tpu_torch.models.convert_flax import (fpn_flax_to_state_dict,
                                                 point_pillars_flax_to_state_dict)
from dal3d_tpu_torch.models.detectors.point_pillars import PointPillars
from dal3d_tpu_torch.models.necks.fpn import FPN
from dal3d_tpu_torch.models.readers.pillar_encoder import PointPillarsScatter, pillarize
from dal3d_tpu_torch.ops.voxelize import VoxelConfig
from test_torch_camera_branch import few_threads  # noqa: F401
from torch_port_utils import t

pytestmark = pytest.mark.usefixtures("few_threads")

TOL = 1e-4
RANGE = (-8.0, -8.0, -3.0, 8.0, 8.0, 1.0)
VOXEL = (0.5, 0.5, 4.0)
# tests/test_extras.py:49-64's detector: 16 m at 0.5 m, PFN (64,), RPN
# layers (1, 1, 1) with filters (16, 32, 64) / (16, 16, 16)
PP_KW = dict(num_classes=(1,), num_input_features=5, rpn_layer_nums=(1, 1, 1),
             rpn_ds_filters=(16, 32, 64), rpn_us_filters=(16, 16, 16))
FPN_SHAPES = [(2, 12, 20, 8), (2, 6, 10, 16), (2, 4, 5, 24), (2, 3, 3, 24)]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _clouds(seed, B=2, P=1024, F=5, extent=7.9):
    """Points inside the grid and some outside it in x, y or z, a few
    non-finite ones and an invalid tail."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((B, P, F), np.float32)
    pts[..., :2] = rng.uniform(-extent, extent, (B, P, 2))
    pts[..., 2] = rng.uniform(-2.9, 0.9, (B, P))
    pts[..., 3:] = rng.uniform(0, 1, (B, P, F - 3))
    pts[:, :40, 0] = rng.uniform(8.0, 12.0, (B, 40))  # past the grid in x
    pts[:, 40:60, 2] = rng.uniform(1.0, 3.0, (B, 20))  # above z_max
    pts[:, 60:64, 1] = np.nan
    pts[:, 64:66, 0] = np.inf
    valid = np.ones((B, P), bool)
    valid[:, -100:] = False
    return pts, valid


def _weights(shapes, seed):
    """Flax variables of the shapes that ``jax.eval_shape`` of an init
    gives, drawn with numpy so that every mapped tensor matters: kernels at
    1/sqrt(fan-in), scales and variances in [0.5, 1.5], biases and means
    near 0."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            x = rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        elif "scale" in name or "var" in name:
            x = rng.uniform(0.5, 1.5, s.shape)
        else:
            x = rng.normal(0, 0.1, s.shape)
        return x.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def ref():
    """JAX's side, one jit: ``pillarize`` of the raw clouds at a cap of 500
    and of 40 pillars; the detector's eval forward on the same clouds made
    finite (the PFN multiplies by the in-grid mask, as JAX's), its PFN and
    scatter outputs captured; that PFN in train mode with its updated
    statistics, and its scatter; the FPN. The port's detector is loaded
    from the same weights."""
    pts, valid = _clouds(3)
    finite = np.nan_to_num(pts, nan=0.0, posinf=0.0)
    cfg = JVoxelConfig(RANGE, VOXEL, 20, 500)
    jm = JPointPillars(voxel_cfg=cfg, **PP_KW)
    jpfn = JPFN(num_input_features=5, num_filters=(64,), voxel_size=VOXEL[:2],
                pc_range=RANGE[:2])
    jfpn = JFPN(out_channels=16, num_outs=3)
    rng = np.random.RandomState(5)
    xs = [rng.normal(0, 1, s).astype(np.float32) for s in FPN_SHAPES]
    args = [jnp.asarray(a) for a in (pts, valid, finite)] + [[jnp.asarray(x) for x in xs]]
    key = jax.random.PRNGKey(0)
    var = _weights(jax.eval_shape(lambda f, v: jm.init(key, f, v, False), args[2], args[1]), 4)
    fvar = _weights(jax.eval_shape(lambda x: jfpn.init(key, x), args[3]), 6)
    nx, ny, _ = cfg.grid_size

    def run(var, fvar, pts, valid, finite, xs):
        caps = {M: jax.vmap(lambda p, v: jpillarize(p, v, JVoxelConfig(RANGE, VOXEL, 20, M)))(
            pts, valid) for M in (500, 40)}
        out, state = jm.apply(var, finite, valid, False, capture_intermediates=True,
                              mutable=["intermediates"])
        inter = state["intermediates"]
        pfn_in = jax.vmap(lambda p, v: jpillarize(p, v, cfg))(finite, valid)
        sub = {k: var[k]["PillarFeatureNet_0"] for k in ("params", "batch_stats")}
        train, upd = jpfn.apply(sub, finite, *pfn_in, True, mutable=["batch_stats"])
        return dict(caps=caps, out=out, pfn=inter["PillarFeatureNet_0"]["__call__"][0],
                    canvas=inter["PointPillarsScatter_0"]["__call__"][0], pfn_train=train,
                    stats=upd["batch_stats"], canvas_train=JScatter(64).apply(
                        {}, train, pfn_in[2], pfn_in[3], nx, ny),
                    fpn=jfpn.apply(fvar, xs))

    res = jax.device_get(jax.jit(run)(var, fvar, *args))
    tm = PointPillars(VoxelConfig(RANGE, VOXEL, 20, 500), **PP_KW).eval()
    tm.load_state_dict(point_pillars_flax_to_state_dict(var, tm), strict=True)
    n_params = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(var["params"]))
    return dict(res, pts=pts, valid=valid, finite=finite, xs=xs, fvar=fvar, tm=tm,
                n_params=n_params)


@pytest.mark.parametrize("M", [500, 40])
def test_pillarize_is_bit_equal(ref, M):
    got = pillarize(t(ref["pts"]), t(ref["valid"]), VoxelConfig(RANGE, VOXEL, 20, M))
    want = ref["caps"][M]
    for w, g in zip(want, got):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w)
    if M == 40:  # the cap binds: the first 40 occupied cells in ascending order
        assert (np.asarray(want[3]).sum(1) == 40).all()


@pytest.mark.parametrize("train", [False, True])
def test_pillar_feature_net_and_scatter(ref, train):
    """The detector's PFN (its converted weights) on the port's pillars of
    the finite clouds; in train mode its running statistics too; the
    scatter of JAX's PFN output bit for bit."""
    tm = copy.deepcopy(ref["tm"].pfn).train(train)
    ok, pid, coords, pvalid = pillarize(t(ref["finite"]), t(ref["valid"]),
                                        VoxelConfig(RANGE, VOXEL, 20, 500))
    with torch.no_grad():
        got = tm(t(ref["finite"]), ok, pid, coords, pvalid)
    want = ref["pfn_train"] if train else ref["pfn"]
    assert _rel(got, want) <= TOL
    if train:
        new = ref["stats"]["MaskedBatchNorm_0"]
        assert _rel(tm.norms[0].running_mean, new["mean"]) <= TOL
        assert _rel(tm.norms[0].running_var, new["var"]) <= TOL
    canvas = PointPillarsScatter(64)(t(want), coords, pvalid, 32, 32)
    want_canvas = ref["canvas_train"] if train else ref["canvas"]
    assert canvas.shape == (2, 32, 32, 64) and np.array_equal(canvas.numpy(),
                                                              np.asarray(want_canvas))


def test_point_pillars_forward_against_jax(ref):
    tm, want = ref["tm"], ref["out"]
    with torch.no_grad():
        got = tm(t(ref["finite"]), t(ref["valid"]))
    assert got["preds"][0]["box_preds"].shape == (2, 16, 16, 20)
    for k in ("box_preds", "cls_preds"):
        assert _rel(got["preds"][0][k], want["preds"][0][k]) <= TOL
    assert _rel(got["neck_feat"], want["neck_feat"]) <= TOL
    assert _rel(got["embedding"], want["embedding"]) <= TOL
    assert sum(p.numel() for p in tm.parameters()) == ref["n_params"]


def test_fpn_against_jax(ref):
    tm = FPN([8, 16, 24, 24], out_channels=16, num_outs=3)
    tm.load_state_dict(fpn_flax_to_state_dict(ref["fvar"]["params"], tm), strict=True)
    with torch.no_grad():
        got = tm([t(x) for x in ref["xs"]])
    assert len(got) == len(ref["fpn"]) == 3
    for g, w in zip(got, ref["fpn"]):
        assert g.shape == w.shape and _rel(g, w) <= TOL
