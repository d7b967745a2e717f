"""Port parity of the CBGS FPNVoxelNet on the brick, hybrid and dense
backbone engines against the JAX package's same ``impl``, on the CPU, at
``torch_port_utils.small_cfg`` sizes (sparse shape (41, 64, 64), B=2,
production widths), with caps that make one level overflow in one frame:
brick caps (470, 1024, 384, 96, 48) (L0 holds 459 and 477 bricks), hybrid
voxel caps (1920, ...) (its L0 downsample makes 1964 and 1897 sites); the
dense engine has no caps.

One jitted JAX function per engine gives the eval forward's maps and
``middle`` levels, JAX's predict step (inlined), and ``jax.grad`` of a fixed
random projection of the train-mode dense map w.r.t. the backbone's
parameters, with the batch statistics that train-mode forward leaves. The
port's model gets the same numpy-randomised variables through
``convert_flax.flax_to_state_dict`` (L0 nested for brick and hybrid, inlined
for dense: the names of JAX's real trees, remat-wrapped modules included).

Required: the brick engine's packing and per-level output bricks bit-equal,
its masks equal; the maps and ``middle`` within 1e-4 of scale; the
detections equal as sets; the backbone's gradient within 1e-2 of its scale
(a ReLU input within rounding of zero may change side, see the test); the
running statistics after one train-mode forward and backward equal to
JAX's (the dense engine recomputes its units in backward, and must move
them once). And the five engines' maps agree with one another where no cap
drops."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.models.backbones.scn import FPNSpMiddleResNetFHD as JaxBackbone
from dal3d_tpu.models.builder import build_detector as jax_build
from dal3d_tpu.ops import sparse_grid as jsg
from dal3d_tpu.runtime.steps import make_predict_step as jax_make_predict_step
from dal3d_tpu.utils.config import Config as JaxConfig
from dal3d_tpu_torch.models.builder import build_detector
from dal3d_tpu_torch.models.convert_flax import flax_to_state_dict, load_flax_variables
from dal3d_tpu_torch.ops import dense_sparse as ds
from dal3d_tpu_torch.ops import sparse_backend as sp
from dal3d_tpu_torch.ops import sparse_brick as spb
from dal3d_tpu_torch.runtime.steps import make_predict_step
from test_torch_camera_branch import few_threads  # noqa: F401
from test_torch_predict import _randomize
from torch_port_utils import small_cfg, small_voxels, t

pytestmark = pytest.mark.usefixtures("few_threads")

SHAPE = (41, 64, 64)
BRICK_CAPS = (470, 1024, 384, 96, 48)
VOXEL_CAPS = (1920, 1536, 384, 128)
ENGINES = ("brick", "hybrid", "dense")
GRAD_TOL = 1e-2  # of the gradient's scale: a ReLU unit within rounding of zero may flip


def engine_cfg(impl, **over):
    cfg = copy.deepcopy(small_cfg())
    bb = cfg["model"]["backbone"]
    for k in ("banded_caps", "band_widths", "down_bands", "band_fb_cap"):
        bb.pop(k, None)
    bb.update(dict(dict(impl=impl, dtype="float32", brick_caps=BRICK_CAPS,
                        voxel_caps=VOXEL_CAPS), **over))
    return cfg


def _jax_input(impl, voxels):
    if impl == "brick":
        return voxels + (SHAPE,)
    return jsg.from_voxels(*voxels, SHAPE)


@pytest.fixture(scope="module", params=ENGINES)
def jax_ref(request):
    return jax_run(request.param)


def jax_run(impl):
    cfg = engine_cfg(impl)
    vf, vc, vv = small_voxels(0)
    jb = jax_build(JaxConfig(cfg))
    assert jb.model.backbone_impl == impl
    voxels = (jnp.asarray(vf), jnp.asarray(vc), jnp.asarray(vv))
    dummy = (jnp.zeros((2, 1, 5), jnp.float32), jnp.zeros((2, 1), bool))
    shapes = jax.eval_shape(lambda: jb.model.init(jax.random.PRNGKey(0), *dummy, False,
                                                  voxels=voxels))
    variables = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape), shapes),
                           np.random.RandomState(1))
    proj = np.random.RandomState(2).randn(2, 8, 8, 256).astype(np.float32)
    predict = jax_make_predict_step(jb)
    backbone = JaxBackbone(num_input_features=5, voxel_caps=VOXEL_CAPS, impl=impl,
                           brick_widths=cfg["model"]["backbone"]["brick_widths"],
                           brick_caps=BRICK_CAPS)

    @jax.jit
    def run(variables, voxels, proj):
        jout, state = jb.model.apply(
            variables, *dummy, False, voxels=voxels, mutable=["intermediates"],
            capture_intermediates=lambda mdl, _: isinstance(mdl, JaxBackbone))
        dets = predict(variables["params"], variables["batch_stats"],
                       {"voxel_features": voxels[0], "voxel_coords": voxels[1],
                        "voxel_valid": voxels[2]})

        def scalar(p):
            (dense, _), new = backbone.apply(
                {"params": p, "batch_stats": variables["batch_stats"]["FPNSpMiddleResNetFHD_0"]},
                _jax_input(impl, voxels), True, mutable=["batch_stats"])
            return (dense * proj).sum(), new["batch_stats"]

        grads, stats = jax.grad(scalar, has_aux=True)(variables["params"]["FPNSpMiddleResNetFHD_0"])
        dense, middle = state["intermediates"]["FPNSpMiddleResNetFHD_0"]["__call__"][0]
        maps = {"dense": dense, "neck": jout["neck_feat"], "embedding": jout["embedding"]}
        for i, p in enumerate(jout["preds"]):
            maps[f"box_preds{i}"], maps[f"cls_preds{i}"] = p["box_preds"], p["cls_preds"]
        return maps, middle, dets, grads, stats

    out = jax.tree_util.tree_map(np.array, run(variables, voxels, proj))
    return impl, variables, proj, out


def _port(impl, variables):
    tb = build_detector(engine_cfg(impl), device="cpu")
    assert tb.model.backbone.impl == impl
    load_flax_variables(tb.model, variables)
    return tb


def _close(got, want, tol, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(float(np.abs(want).max()), 1e-30)
    assert got.shape == want.shape, what
    assert float(np.abs(got - want).max()) <= tol * scale, what


def test_maps_middle_and_detections_match_jax(jax_ref):
    impl, variables, _, (ref_maps, jmid, jd, _, _) = jax_ref
    vf, vc, vv = small_voxels(0)
    tb = _port(impl, variables)
    with torch.inference_mode():
        out = tb.model(t(vf), t(vc), t(vv))
    maps = {"dense": out["dense"], "neck": out["neck_feat"], "embedding": out["embedding"]}
    for i, p in enumerate(out["preds"]):
        maps[f"box_preds{i}"], maps[f"cls_preds{i}"] = p["box_preds"], p["cls_preds"]
    for name, ref in ref_maps.items():
        _close(maps[name], ref, 1e-4, name)
    assert np.abs(ref_maps["dense"]).max() > 0
    scale = max(float(np.abs(np.asarray(getattr(m, "features", m[0] if isinstance(m, tuple)
                                                else m))).max()) for m in jmid)
    for lvl, (got, want) in enumerate(zip(out["middle"], jmid)):
        if impl == "brick":
            assert isinstance(got, spb.BrickBatch) and got.bw == want.bw
            np.testing.assert_array_equal(got.brick_lin.numpy(), want.brick_lin)
            np.testing.assert_array_equal(got.vmask.numpy(), want.vmask)
            _close(got.features, want.features, 1e-4 * scale / max(
                float(np.abs(want.features).max()), 1e-30), f"middle[{lvl}]")
        elif impl == "hybrid" and lvl == 0:
            assert isinstance(got, sp.SparseBatch)
            np.testing.assert_array_equal(got.lin.numpy(), want.lin)
            _close(got.features, want.features, 1e-4, "middle[0]")
        else:
            assert isinstance(got, tuple)
            np.testing.assert_array_equal(got[1].numpy(), want[1])
            _close(got[0], want[0], 1e-4, f"middle[{lvl}]")
    td = make_predict_step(tb)({"voxel_features": vf, "voxel_coords": vc, "voxel_valid": vv})
    for b in range(2):
        jv, tv = jd["det_valid"][b], td["det_valid"][b].numpy()
        assert jv.sum() == tv.sum() > 5
        js, ts = jd["scores"][b][jv], td["scores"][b].numpy()[tv]
        jo, to = np.argsort(-js, kind="stable"), np.argsort(-ts, kind="stable")
        np.testing.assert_allclose(ts[to], js[jo], rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(td["label_preds"][b].numpy()[tv][to],
                                      jd["label_preds"][b][jv][jo])
        np.testing.assert_allclose(td["box3d_lidar"][b].numpy()[tv][to],
                                   jd["box3d_lidar"][b][jv][jo], rtol=1e-4, atol=1e-4)


def _train_step(impl, variables, proj, checkpointed=None):
    """The port's backbone in train mode: forward, the projection's backward.
    Returns (the model's bundle, {state-dict name: grad})."""
    vf, vc, vv = small_voxels(0)
    tb = _port(impl, variables)
    bb = tb.model.backbone.train()
    for lvl in (bb.l0, bb.stage1, bb.stage2, bb.stage3):
        assert lvl.checkpointed == (impl == "dense")
        if checkpointed is not None:
            lvl.checkpointed = checkpointed
    dense, _ = bb(t(vf), t(vc), t(vv))
    (dense * t(proj)).sum().backward()
    return tb, {f"backbone.{k}": p.grad for k, p in bb.named_parameters()}


def test_gradient_and_running_stats_match_jax(jax_ref):
    """The backbone's gradient within GRAD_TOL of its scale of jax.grad's.
    At this size some thirty ReLU inputs of a train-mode forward lie within
    1e-6 of their tensor's scale of zero, and the summation order of the
    libraries' convs decides which side one of them falls on (one at +-3e-7
    flips here); a flipped unit moves the train-mode gradient by up to
    ~5e-3 of its scale, through the batch norms' statistics, where a fault
    in a backward (a tap, a mask, a transposed weight) moves it by O(0.1).
    The dense engine's gradient with recomputation is bit-equal to the same
    forward without it. The running statistics after the forward and
    backward equal JAX's on every engine (moved once)."""
    impl, variables, proj, (_, _, _, jgrads, jstats) = jax_ref
    tb, got = _train_step(impl, variables, proj)
    bb = tb.model.backbone
    params = dict(variables["params"], FPNSpMiddleResNetFHD_0=jgrads)
    stats = dict(variables["batch_stats"], FPNSpMiddleResNetFHD_0=jstats)
    want = flax_to_state_dict({"params": params, "batch_stats": stats}, tb.model)
    assert len(got) == 79  # 4 levels x (2 blocks x 8 + down + its BN) + the stem and its BN
    # one scale for the whole gradient: a conv bias under a train-mode batch
    # norm has a zero gradient in exact arithmetic, so its own scale is noise
    scale = max(float(want[k].abs().max()) for k in got)
    for k, g in got.items():
        assert float((g - want[k]).abs().max()) <= GRAD_TOL * scale, k
    if impl == "dense":
        _, plain = _train_step(impl, variables, proj, checkpointed=False)
        for k, g in got.items():
            assert torch.equal(g, plain[k]), k
    # the running statistics moved once, as JAX's
    before = flax_to_state_dict(variables, tb.model)
    running = {f"backbone.{k}": v for k, v in bb.state_dict().items() if "running" in k}
    assert len(running) == 2 * 21
    for k, v in running.items():
        assert not torch.equal(v, before[k]), k
        assert float((v - want[k]).abs().max()) <= 1e-5 * float(want[k].abs().max()), k


def test_engines_agree_where_no_cap_drops():
    """The five engines, one state dict: maps within 1e-4 of scale, each
    level's active set and features the same (as dense grids)."""
    vf, vc, vv = small_voxels(0)
    wide = dict(brick_caps=(600, 1200, 600, 200, 100), voxel_caps=(4000, 4000, 4000, 4000),
                banded_caps=(600, 1280, 640, 256, 128), band_widths=(256, 256, 128, 128, 128),
                down_bands=(512, 256, 128, 128), band_fb_cap=2048)
    ref_sd = None
    maps, levels = {}, {}
    for impl in ("gather", "banded", "brick", "hybrid", "dense"):
        model = build_detector(engine_cfg(impl, **wide), device="cpu", seed=4).model
        if ref_sd is None:
            ref_sd = model.state_dict()
        model.load_state_dict(ref_sd)
        with torch.inference_mode():
            out = model(t(vf), t(vc), t(vv))
        maps[impl] = out["dense"]
        levels[impl] = [_as_grid(m) for m in out["middle"]]
    scale = float(maps["gather"].abs().max())
    for impl in maps:
        assert float((maps[impl] - maps["gather"]).abs().max()) <= 1e-4 * scale, impl
        for lvl, (d, o) in enumerate(levels[impl]):
            gd, go = levels["gather"][lvl]
            assert torch.equal(o, go), (impl, lvl)
            assert float((d - gd).abs().max()) <= 1e-4 * float(gd.abs().max()), (impl, lvl)


def _as_grid(m):
    """A middle level of any engine -> (dense [B, D, H, W, C], occupancy)."""
    if isinstance(m, tuple):
        return m[0].float(), m[1] > 0
    if isinstance(m, sp.SparseBatch):
        d, o = ds.to_dense_grid(m)
        return d, o > 0
    B, Mb, _ = m.features.shape
    D, H, W = m.shape
    nbc = m.num_cells
    dense = torch.zeros(B, nbc + 1, m.bw, m.channels)
    occ = torch.zeros(B, nbc + 1, m.bw, dtype=torch.bool)
    lin = torch.clamp(m.brick_lin.long(), max=nbc)
    dense.scatter_(1, lin[..., None, None].expand(B, Mb, m.bw, m.channels), m.feat4().float())
    occ.scatter_(1, lin[..., None].expand(B, Mb, m.bw), m.vmask)
    return (dense[:, :nbc].reshape(B, D, H, W, m.channels), occ[:, :nbc].reshape(B, D, H, W))


def test_capacity_report_reads_the_brick_caps():
    """The brick engine's report equals JAX's ``brick_capacity_report`` on
    the same batch (level 0 the uncapped demand, over its cap in one frame;
    levels 1-4 the compacted counts); the hybrid and dense engines give
    none, as JAX's."""
    from dal3d_tpu.runtime.capacity import brick_capacity_report as jax_report
    from dal3d_tpu_torch.runtime.capacity import brick_capacity_report

    vf, vc, vv = small_voxels(0)
    batch = {"voxel_features": vf, "voxel_coords": vc, "voxel_valid": vv}
    jb = jax_build(JaxConfig(engine_cfg("brick")))
    shapes = jax.eval_shape(lambda: jb.model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 1, 5)), jnp.zeros((2, 1), bool), False,
        voxels=tuple(jnp.asarray(a) for a in (vf, vc, vv))))
    variables = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    want = jax_report(jb, variables["params"], variables["batch_stats"], batch)
    got = brick_capacity_report(build_detector(engine_cfg("brick"), device="cpu"), batch)
    assert got == want
    assert [r["cap"] for r in got] == list(BRICK_CAPS)
    assert got[0]["active"] == 477 and got[0]["saturated"]
    for impl in ("hybrid", "dense"):
        assert brick_capacity_report(build_detector(engine_cfg(impl), device="cpu"), batch) == []


def test_non_fpn_backbone_is_the_hybrid_map():
    """``SpMiddleResNetFHD`` (JAX's non-FPN variant: the dense map alone, the
    hybrid engine in f32) gives the FPN backbone's map on the same weights."""
    from dal3d_tpu_torch.models.backbones.scn import FPNSpMiddleResNetFHD, SpMiddleResNetFHD
    from dal3d_tpu_torch.models.builder import init_random_

    vf, vc, vv = small_voxels(0)
    plain = init_random_(SpMiddleResNetFHD(SHAPE, voxel_caps=VOXEL_CAPS),
                         torch.Generator().manual_seed(0)).eval()
    fpn = FPNSpMiddleResNetFHD(SHAPE, impl="hybrid", voxel_caps=VOXEL_CAPS).eval()
    assert plain.impl == "hybrid" and plain.l0.stem.dtype == torch.float32
    fpn.load_state_dict(plain.state_dict(), strict=True)
    with torch.inference_mode():
        got = plain(t(vf), t(vc), t(vv))
        want, _ = fpn(t(vf), t(vc), t(vv))
    assert torch.equal(got, want) and got.shape == (2, 8, 8, 256) and got.abs().max() > 0
