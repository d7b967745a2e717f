"""Port parity for the slice as a whole: the banded FPNVoxelNet predict of
dal3d_tpu_torch against dal3d_tpu on the same host voxels and weights.

JAX initialises the model; its variables are randomised with numpy (so that
activations and scores spread out) and carried across by the weights bridge
(models/convert_flax.py). The config is the production CBGS one cut to a
12.8 m grid (tests/torch_port_utils.py::small_cfg); JAX runs its banded
engine on the CPU (XLA twins, band plans + exact fallback).

f32: the dense backbone map, the neck, the embedding and every head map
agree within rtol/atol 1e-4, and the post-NMS detections under exact top-k
agree as matched sets, with the score entropy. bf16: JAX's CPU runtime
cannot run its bf16 banded path, so the port's bf16 run is held to JAX's
f32 run: every map within BF16_TOL of its scale (bf16 keeps 8 bits; the
error compounds over 20 sparse layers and 12 RPN layers)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.core.anchors import generate_task_anchors as jax_anchors
from dal3d_tpu.core.box_coders import GroundBox3dCoder as JaxCoder
from dal3d_tpu.models.backbones.scn import FPNSpMiddleResNetFHD as JaxBackbone
from dal3d_tpu.models.builder import build_detector as jax_build
from dal3d_tpu.runtime.steps import make_predict_step as jax_make_predict_step
from dal3d_tpu.utils.config import Config as JaxConfig
from dal3d_tpu_torch.core.anchors import generate_task_anchors
from dal3d_tpu_torch.core.box_coders import GroundBox3dCoder
from dal3d_tpu_torch.models.builder import build_detector
from dal3d_tpu_torch.models.convert_flax import load_flax_variables
from dal3d_tpu_torch.runtime.steps import make_predict_step
from dal3d_tpu_torch.utils.config import Config
from torch_port_utils import small_cfg, small_voxels, t

BF16_TOL = 5e-2
CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def _randomize(tree, rng, path=""):
    """Seeded numpy values for every leaf of a flax variables tree: kernels
    ~ N(0, 2/fan_in), biases ~ 0.05 N(0, 1), BN scale/bias/mean/var near the
    identity with 10-20 % spread."""
    out = {}
    for k, v in tree.items():
        p = f"{path}/{k}"
        if isinstance(v, dict):
            out[k] = _randomize(v, rng, p)
            continue
        shape = np.shape(v)
        if k == "kernel":
            x = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
        elif k == "scale":
            x = 1 + 0.2 * rng.randn(*shape)
        elif k == "var":
            x = 1 + 0.1 * rng.rand(*shape)
        elif k == "mean" or ("Norm" in p and k == "bias"):
            x = 0.1 * rng.randn(*shape)
        else:  # conv bias
            x = 0.05 * rng.randn(*shape)
        out[k] = x.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's f32 banded model on the small config: (variables, maps, the
    output of JAX's predict step).
    (JAX's CPU runtime cannot run its bf16 banded path: the XLA twin's bf16 x
    bf16 -> f32 dot is unsupported there, so f32 JAX is the reference for
    both port dtypes.)"""
    cfg = small_cfg("float32")
    vf, vc, vv = small_voxels(0)
    jb = jax_build(JaxConfig(cfg))
    voxels = (jnp.asarray(vf), jnp.asarray(vc), jnp.asarray(vv))
    dummy = (jnp.zeros((2, 1, 5), jnp.float32), jnp.zeros((2, 1), bool))
    shapes = jax.eval_shape(lambda: jb.model.init(jax.random.PRNGKey(0), *dummy, False,
                                                  voxels=voxels))
    variables = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape), shapes),
                           np.random.RandomState(1))
    apply = jax.jit(lambda v, vox: jb.model.apply(
        v, *dummy, False, voxels=vox, mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, JaxBackbone)))
    jout, state = apply(variables, voxels)
    maps = {"dense": state["intermediates"]["FPNSpMiddleResNetFHD_0"]["__call__"][0][0],
            "neck": jout["neck_feat"], "embedding": jout["embedding"]}
    for i, p in enumerate(jout["preds"]):
        maps[f"box_preds{i}"], maps[f"cls_preds{i}"] = p["box_preds"], p["cls_preds"]
    step = jax_make_predict_step(jb)(variables["params"], variables["batch_stats"],
                                     {"voxel_features": voxels[0], "voxel_coords": voxels[1],
                                      "voxel_valid": voxels[2]})
    return (variables, {k: np.asarray(v, np.float32) for k, v in maps.items()},
            {k: np.asarray(v) for k, v in step.items()})


def _port(variables, dtype):
    """The port's maps and predict-step output on the same voxels and
    weights."""
    vf, vc, vv = small_voxels(0)
    tb = build_detector(small_cfg(dtype), device="cpu")
    load_flax_variables(tb.model, variables)
    vf = t(vf, torch.bfloat16 if dtype == "bfloat16" else None)
    with torch.inference_mode():
        out = tb.model(vf, t(vc), t(vv))
    step = make_predict_step(tb)({"voxel_features": vf, "voxel_coords": vc, "voxel_valid": vv})
    maps = {"dense": out["dense"], "neck": out["neck_feat"], "embedding": out["embedding"]}
    for i, p in enumerate(out["preds"]):
        maps[f"box_preds{i}"], maps[f"cls_preds{i}"] = p["box_preds"], p["cls_preds"]
    return {k: v.float().numpy() for k, v in maps.items()}, step


def test_predict_matches_jax_f32(jax_ref):
    variables, ref_maps, jd = jax_ref
    maps, tdets = _port(variables, "float32")
    assert np.abs(ref_maps["dense"]).max() > 0  # the backbone map is not empty
    for name, ref in ref_maps.items():
        assert maps[name].shape == ref.shape, name
        np.testing.assert_allclose(maps[name], ref, rtol=1e-4, atol=1e-4, err_msg=name)
    for b in range(2):
        jv, tv = jd["det_valid"][b], tdets["det_valid"][b].numpy()
        assert jv.sum() == tv.sum() > 10
        # matched sets: order both by score (distinct in f32 here), compare
        js, ts = jd["scores"][b][jv], tdets["scores"][b].numpy()[tv]
        jo, to = np.argsort(-js, kind="stable"), np.argsort(-ts, kind="stable")
        assert len(np.unique(js)) == len(js)
        np.testing.assert_allclose(ts[to], js[jo], rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(tdets["label_preds"][b].numpy()[tv][to],
                                      jd["label_preds"][b][jv][jo])
        np.testing.assert_allclose(tdets["box3d_lidar"][b].numpy()[tv][to],
                                   jd["box3d_lidar"][b][jv][jo], rtol=1e-4, atol=1e-4)
    # the rest of the predict step's dict
    assert set(tdets) == set(jd)
    for k in ("embedding", "score_entropy"):
        np.testing.assert_allclose(tdets[k].numpy(), jd[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_predict_bf16_close_to_jax_f32(jax_ref):
    variables, ref_maps, _ = jax_ref
    maps, _ = _port(variables, "bfloat16")
    for name, ref in ref_maps.items():
        scale = max(float(np.abs(ref).max()), 1e-30)
        err = float(np.abs(maps[name] - ref).max())
        assert err <= BF16_TOL * scale, (name, err, scale)


def test_anchors_and_decode_match_jax():
    cfg = Config.fromfile(os.path.join(CONFIGS, "cbgs_spatial_temporal.py"))
    gens = [dict(g) for g in cfg["target_assigner"]["anchor_generators"]]
    tasks = [dict(x) for x in cfg["tasks"]]
    ref = jax_anchors(gens, tasks, [1, 128, 128])
    got = generate_task_anchors(gens, tasks, [1, 128, 128])
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.anchors, r.anchors)
        assert g.class_names == r.class_names
    rng = np.random.RandomState(0)
    enc = (rng.randn(500, 10) * 0.5).astype(np.float32)
    anchors = got[1].anchors[rng.randint(0, len(got[1].anchors), 500)]
    want = JaxCoder(vec_encode=True, n_dim=9).decode_jax(jnp.asarray(enc), jnp.asarray(anchors))
    have = GroundBox3dCoder(vec_encode=True, n_dim=9).decode(t(enc), t(anchors))
    np.testing.assert_allclose(have.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["cbgs_spatial_temporal.py", "cbgs_entropy.py"])
def test_config_loader_matches_jax(name):
    from dal3d_tpu.utils.config import Config as JC

    path = os.path.join(CONFIGS, name)
    got, ref = Config.fromfile(path), JC.fromfile(path)
    assert set(got.keys()) == set(ref.keys())
    for k in ("model", "tasks", "voxel_generator", "test_cfg", "target_assigner", "box_coder"):
        assert got[k] == ref[k], k
