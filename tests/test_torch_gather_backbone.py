"""Port parity of the CBGS FPNVoxelNet on the gather engine (``impl="gather"``,
JAX's default when a config names no engine) against the JAX package's, on
the CPU, at ``torch_port_utils.small_cfg`` sizes (sparse shape (41, 64, 64),
B=2) with voxel caps (1920, 1536, 384, 128): the first downsample
overflows its cap in one frame, the last fills it.

One jitted JAX function gives every level's subm rulebook and downsample
plan (chained from the voxels), the eval forward's dense map, neck, embedding
and head maps, JAX's predict step (inlined), and ``jax.grad`` of a fixed
random projection of the train-mode dense map w.r.t. the backbone's
parameters. The port's model gets the same numpy-randomised variables through
``convert_flax.flax_to_state_dict`` (L0 inlined in JAX's gather layout).

Required: the plans bit-equal (the port shares each level's index grid
between the rulebook and the downsample; JAX builds it twice); the maps
within 1e-4 of scale; the detections equal as sets (paired by score); the
backbone's gradient within 1e-3 of its scale. The weight bridges: ``convert_second``
into a gather model is bit-equal to JAX's ``nested_l0=False`` route, and a
banded model's state dict loads into a gather model as it is."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.models.backbones.scn import FPNSpMiddleResNetFHD as JaxBackbone
from dal3d_tpu.models.builder import build_detector as jax_build
from dal3d_tpu.models.convert_second import convert_second_state_dict as jax_convert
from dal3d_tpu.ops import sparse_grid as jsg
from dal3d_tpu.runtime.steps import make_predict_step as jax_make_predict_step
from dal3d_tpu.utils.config import Config as JaxConfig
from dal3d_tpu_torch.models import convert_second as cs
from dal3d_tpu_torch.models.builder import build_detector
from dal3d_tpu_torch.models.convert_flax import flax_to_state_dict, load_flax_variables
from dal3d_tpu_torch.models.detectors.voxelnet import FPNVoxelNet
from dal3d_tpu_torch.ops import sparse_backend as sp
from dal3d_tpu_torch.runtime.steps import make_predict_step
from oracle_utils import (DS_FILTERS, DS_STRIDES, LAYER_NUMS, NUM_CLASSES, US_FILTERS,
                          US_STRIDES, VCFG, rnd_state_dict)
from test_torch_camera_branch import few_threads  # noqa: F401
from test_torch_predict import _randomize
from torch_port_utils import small_gather_cfg, small_voxels, t

pytestmark = pytest.mark.usefixtures("few_threads")

CAPS = (1920, 1536, 384, 128)
SHAPE = (41, 64, 64)
DOWNS = (((3, 3, 3), (2, 2, 2), (1, 1, 1)), ((3, 3, 3), (2, 2, 2), (1, 1, 1)),
         ((3, 3, 3), (2, 2, 2), (0, 1, 1)), ((3, 1, 1), (2, 1, 1), (0, 0, 0)))


def _jax_plans(vf, vc, vv):
    sb = jsg.from_voxels(vf, vc, vv, SHAPE)
    out = []
    for cap, (k, s, p) in zip(CAPS, DOWNS):
        rb = jsg.subm_rulebook(sb, 3)
        down = jsg.downsample_plan(sb, k, s, p, cap)
        out.append((rb, down[:3]))
        sb = sb.replace(features=jnp.zeros(down[0].shape + (1,)), lin=down[0], shape=down[3])
    return out


@pytest.fixture(scope="module")
def jax_ref():
    cfg = small_gather_cfg(CAPS)
    vf, vc, vv = small_voxels(0)
    jb = jax_build(JaxConfig(cfg))
    assert jb.model.backbone_impl == "gather"
    voxels = (jnp.asarray(vf), jnp.asarray(vc), jnp.asarray(vv))
    dummy = (jnp.zeros((2, 1, 5), jnp.float32), jnp.zeros((2, 1), bool))
    shapes = jax.eval_shape(lambda: jb.model.init(jax.random.PRNGKey(0), *dummy, False,
                                                  voxels=voxels))
    variables = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape), shapes),
                           np.random.RandomState(1))
    proj = np.random.RandomState(2).randn(2, 8, 8, 256).astype(np.float32)
    predict = jax_make_predict_step(jb)
    backbone = JaxBackbone(num_input_features=5, voxel_caps=CAPS, impl="gather")

    @jax.jit
    def run(variables, voxels, proj):
        jout, state = jb.model.apply(
            variables, *dummy, False, voxels=voxels, mutable=["intermediates"],
            capture_intermediates=lambda mdl, _: isinstance(mdl, JaxBackbone))
        dets = predict(variables["params"], variables["batch_stats"],
                       {"voxel_features": voxels[0], "voxel_coords": voxels[1],
                        "voxel_valid": voxels[2]})

        def scalar(p):
            sb = jsg.from_voxels(*voxels, SHAPE)
            (dense, _), _ = backbone.apply(
                {"params": p, "batch_stats": variables["batch_stats"]["FPNSpMiddleResNetFHD_0"]},
                sb, True, mutable=["batch_stats"])
            return (dense * proj).sum()

        grads = jax.grad(scalar)(variables["params"]["FPNSpMiddleResNetFHD_0"])
        maps = {"dense": state["intermediates"]["FPNSpMiddleResNetFHD_0"]["__call__"][0][0],
                "neck": jout["neck_feat"], "embedding": jout["embedding"]}
        for i, p in enumerate(jout["preds"]):
            maps[f"box_preds{i}"], maps[f"cls_preds{i}"] = p["box_preds"], p["cls_preds"]
        return maps, dets, grads, _jax_plans(*voxels)

    out = jax.tree_util.tree_map(np.array, run(variables, voxels, proj))
    return variables, proj, out


def test_plans_bit_equal(jax_ref):
    plans = jax_ref[-1][-1]
    vf, vc, vv = small_voxels(0)
    sb = sp.from_voxels(t(vf), t(vc), t(vv), SHAPE)
    full = []
    for (jrb, jdown), cap, (k, s, p) in zip(plans, CAPS, DOWNS):
        grid = sp.build_index_grid(sb)
        rb = sp.subm_rulebook(sb, 3, grid)  # the port shares the grid; JAX builds it again
        for got, want in zip(rb, jrb):
            np.testing.assert_array_equal(got.numpy(), want)
        down = sp.downsample_plan(sb, k, s, p, cap, grid)
        for got, want in zip(down[:3], jdown):
            np.testing.assert_array_equal(got.numpy(), want)
        full.append(int((down[0] < np.prod(down[3])).sum(-1).max()))
        sb = sp.SparseBatch(features=torch.zeros(*down[0].shape, 1), lin=down[0], shape=down[3])
    assert full[0] == CAPS[0] and full[-1] == CAPS[-1]  # an overflow and a full level


def test_maps_and_detections_match_jax(jax_ref):
    variables, _, (ref_maps, jd, _, _) = jax_ref
    vf, vc, vv = small_voxels(0)
    tb = build_detector(small_gather_cfg(CAPS), device="cpu")
    assert tb.model.backbone.impl == "gather" and tb.model.backbone.caps == CAPS
    load_flax_variables(tb.model, variables)
    with torch.inference_mode():
        out = tb.model(t(vf), t(vc), t(vv))
    assert all(isinstance(m, sp.SparseBatch) for m in out["middle"])
    maps = {"dense": out["dense"], "neck": out["neck_feat"], "embedding": out["embedding"]}
    for i, p in enumerate(out["preds"]):
        maps[f"box_preds{i}"], maps[f"cls_preds{i}"] = p["box_preds"], p["cls_preds"]
    for name, ref in ref_maps.items():
        got = maps[name].float().numpy()
        scale = max(float(np.abs(ref).max()), 1e-30)
        assert got.shape == ref.shape, name
        assert float(np.abs(got - ref).max()) <= 1e-4 * scale, name
    assert np.abs(ref_maps["dense"]).max() > 0
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


def test_backbone_gradient_matches_jax(jax_ref):
    variables, proj, (_, _, jgrads, _) = jax_ref
    vf, vc, vv = small_voxels(0)
    tb = build_detector(small_gather_cfg(CAPS), device="cpu")
    load_flax_variables(tb.model, variables)
    bb = tb.model.backbone.train()
    dense, _ = bb(t(vf), t(vc), t(vv))
    (dense * t(proj)).sum().backward()
    params = dict(variables["params"], FPNSpMiddleResNetFHD_0=jgrads)
    want = flax_to_state_dict({"params": params, "batch_stats": variables["batch_stats"]},
                              tb.model)
    got = {f"backbone.{k}": p.grad for k, p in bb.named_parameters()}
    assert len(got) == 79  # 4 levels x (2 blocks x 8 + down + its BN) + the stem and its BN
    # one scale for the whole gradient: a conv bias under a train-mode batch
    # norm has a zero gradient in exact arithmetic, so its own scale is noise
    scale = max(float(want[k].abs().max()) for k in got)
    for k, g in got.items():
        assert float((g - want[k]).abs().max()) <= 1e-3 * scale, k


def test_weight_bridges_into_a_gather_model():
    kw = dict(num_classes=NUM_CLASSES, rpn_layer_nums=LAYER_NUMS, rpn_ds_strides=DS_STRIDES,
              rpn_ds_filters=DS_FILTERS, rpn_us_strides=US_STRIDES, rpn_us_filters=US_FILTERS)
    gather = FPNVoxelNet(VCFG.sparse_shape, backbone_impl="gather", **kw).eval()
    banded = FPNVoxelNet(VCFG.sparse_shape, brick_widths=(16, 8, 4, 2, 2),
                         banded_caps=(12032, 2048, 512, 256, 256), **kw).eval()
    sd = rnd_state_dict(np.random.RandomState(0))
    params, stats = jax_convert(sd, nested_l0=False)  # JAX's gather layout: L0 inlined
    want = flax_to_state_dict({"params": params, "batch_stats": stats}, gather)
    got = cs.convert_second_state_dict(sd)
    assert set(got) == set(want) == set(gather.state_dict()) == set(banded.state_dict())
    for k, v in want.items():
        assert torch.equal(got[k].view(torch.int32), v.view(torch.int32)), k
    gather.load_state_dict(got, strict=True)
    banded.load_state_dict(got, strict=True)
    gather.load_state_dict(banded.state_dict(), strict=True)  # one checkpoint, either engine
