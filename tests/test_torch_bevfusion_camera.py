"""Port parity for stage 2 as a whole: BEVFusion camera + lidar
(configs/bevfusion_cl.py's model: Swin-T, the LSS FPN, DepthLSSTransform,
ConvFuser; the rest narrow, as tests/test_torch_bevfusion.py's tiny model)
of dal3d_tpu_torch against dal3d_tpu on the same inputs and weights, on the
CPU: B=1, 2 ring cameras at 32 x 48, the (41, 64, 64) lidar grid (whose 8 x 8
BEV map the camera's 180 x 180 map is resized to).

JAX's variables are shaped by ``eval_shape``, filled with seeded numpy values
and carried across by the weights bridge; JAX compiles one apply. Both
models are fed one frustum geometry (JAX's, computed eagerly): a point within
rounding of a BEV cell edge lands in either cell depending on how the
geometry is computed (XLA's fused program moves such points even against
JAX's own eager forward), and tests/test_torch_camera_branch.py counts how
many the port's own geometry moves. Required:
the camera, fused and neck maps, the heatmap and the query predictions
within 1e-4 of their scale, the query labels equal. The ``stop_at`` cuts are
checked on the port alone (each cut equals the full forward's
intermediate), and the port's train step runs from the converted weights
(Swin's stochastic depth drawn from the step's generator): finite logs, the
loss moving."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.models.bevfusion import BEVFusion as JaxBEVFusion
from dal3d_tpu.models.bevfusion import vtransforms as jvt
from dal3d_tpu.ops.voxelize import VoxelConfig as JaxVoxelConfig
from dal3d_tpu_torch.models.bevfusion import vtransforms as tvt
from dal3d_tpu_torch.models.bevfusion.bevfusion import CAMERA_TRANSFORMS
from dal3d_tpu_torch.models.builder import bevfusion_optimizer, build_bevfusion
from dal3d_tpu_torch.models.convert_flax import load_flax_bevfusion
from dal3d_tpu_torch.runtime.bevfusion_steps import (CAMERA_KEYS, make_bevfusion_train_step,
                                                     random_modules)
from test_torch_bevfusion import TINY, VG, _randomize, tiny_cfg
from test_torch_camera_branch import few_threads, ring_cameras  # noqa: F401
from torch_port_utils import small_voxels

pytestmark = pytest.mark.usefixtures("few_threads")

IMG = (32, 48)


def _batch():
    vf, vc, vv = small_voxels(11, B=1, N=1800)
    rng = np.random.RandomState(12)
    rots, trans, K, aug_r, aug_t = ring_cameras(1, 2, IMG, (4, 6), orig_hw=(64, 96),
                                                focal=50.0, seed=13)
    depth = (rng.rand(1, 2, *IMG, 1) * 40 * (rng.rand(1, 2, *IMG, 1) < 0.15)).astype(np.float32)
    return {"voxel_features": vf, "voxel_coords": vc, "voxel_valid": vv,
            "images": rng.randn(1, 2, *IMG, 3).astype(np.float32), "depth_images": depth,
            "camera2lidar_rots": rots, "camera2lidar_trans": trans, "camera_intrinsics": K,
            "img_aug_rots": aug_r, "img_aug_trans": aug_t}


@pytest.fixture(scope="module")
def both():
    """(batch, JAX's preds and camera / fused maps, the port's bundle with
    JAX's weights, the shared geometry in the port's [B, N, fH, fW, D, 3]
    order)."""
    vcfg = JaxVoxelConfig(tuple(VG["range"]), tuple(VG["voxel_size"]), 10, VG["max_voxel_num"])
    model = JaxBEVFusion(voxel_cfg=vcfg, with_camera=True, image_size=IMG, **TINY)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jb, False))
    variables = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes),
                           np.random.RandomState(14))

    def run(v, b):  # one program: the full forward and the cut maps, sharing the work
        preds, inter = model.apply(v, b, False, capture_intermediates=lambda m, _: type(m)
                                   .__name__ in ("ConvFuser", "DepthLSSTransform"))
        return preds, inter

    frustum = jvt.create_frustum(IMG, (IMG[0] // 8, IMG[1] // 8), tvt.DBOUND)
    geom = np.asarray(jvt.get_geometry(jnp.asarray(frustum), *(jb[k] for k in CAMERA_TRANSFORMS)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvt, "get_geometry", lambda *a: jnp.asarray(geom))
        preds, inter = jax.jit(run)(variables, jb)
    inter = inter["intermediates"]
    jmaps = {"camera": np.asarray(inter["DepthLSSTransform_0"]["__call__"][0]),
             "fused": np.asarray(inter["ConvFuser_0"]["__call__"][0])}
    bundle = build_bevfusion(tiny_cfg(with_camera=True, image_size=IMG), device="cpu")
    load_flax_bevfusion(bundle.model, variables)
    port_geom = torch.from_numpy(np.ascontiguousarray(geom.transpose(0, 1, 3, 4, 2, 5)))
    return batch, {k: np.asarray(v) for k, v in preds.items()}, jmaps, bundle, port_geom


def _inputs(batch):
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    return (t["voxel_features"], t["voxel_coords"], t["voxel_valid"]), {
        k: t[k] for k in CAMERA_KEYS}


def _close(got, ref, rel=1e-4):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert got.shape == ref.shape and err <= rel * scale, (err, scale)


def test_stage2_forward_matches_jax_and_cuts_match_the_forward(both, monkeypatch):
    batch, jp, jmaps, bundle, geom = both
    monkeypatch.setattr(tvt, "get_geometry", lambda *a: geom)
    model = bundle.model.eval()
    vox, cam = _inputs(batch)
    seen = {}
    hooks = [m.register_forward_hook(lambda mod, args, out, name=name: seen.__setitem__(name, out))
             for name, m in (("camera", model.camera_vtransform), ("fused", model.fuser))]
    try:
        with torch.inference_mode():
            preds = model(*vox, **cam)
    finally:
        for h in hooks:
            h.remove()
    assert tuple(seen["camera"].shape) == (1, 180, 180, 80)
    _close(seen["camera"], jmaps["camera"])
    _close(seen["fused"], jmaps["fused"])
    _close(preds["bev_feat"], jp["bev_feat"])
    _close(preds["heatmap"], jp["heatmap"])
    assert float(np.abs(jp["heatmap"]).max()) > 0.1
    np.testing.assert_array_equal(preds["query_labels"].numpy(), jp["query_labels"])
    for k in ("query_score", "center", "height", "dim", "rot", "vel", "cls_logits"):
        _close(preds[k], jp[k])
    # the cuts are the full forward's intermediates
    with torch.inference_mode():
        cut_cam = model(*vox, "camera", **cam)
        cut_fused = model(*vox, "fused", **cam)["fused"]
        assert tuple(cut_cam["camera"].shape) == (1, 8, 8, 80)
        assert torch.equal(model.fuser([cut_cam["camera"], cut_cam["lidar"]]), cut_fused)
        assert torch.equal(cut_fused, seen["fused"])
        assert torch.equal(model.neck(model.decoder(cut_fused)), preds["bev_feat"])
        assert torch.equal(model(*vox, "lidar", **cam)["lidar"], cut_cam["lidar"])
    with pytest.raises(ValueError, match="needs images"):
        model(*vox)


def test_train_step_from_converted_weights(both):
    batch, _, _, bundle, _ = both
    model = bundle.model
    assert sum(type(m).__name__ == "DropPath" and m.rate > 0 for m in random_modules(model)) == 11
    rng = np.random.RandomState(15)
    gt = np.zeros((1, 6, 9), np.float32)
    gt[0, :4, :2] = rng.uniform(-5, 5, (4, 2))
    gt[0, :4, 2] = -1.0
    gt[0, :4, 3:6] = (1.9, 4.5, 1.7)
    gt[0, 4:, 3:6] = 1.0
    train = dict(batch, gt_boxes=gt, gt_classes=np.array([[1, 2, 1, 3, 0, 0]], np.int32))
    cfg = tiny_cfg(with_camera=True, image_size=IMG)
    cfg["lr_config"] = dict(lr_max=1e-3)
    opt = bevfusion_optimizer(cfg, bundle, 10)
    step = make_bevfusion_train_step(bundle, opt)
    swin_before = model.camera_backbone.patch_embed.proj.weight.detach().clone()
    logs = [{k: float(v) for k, v in step(train).items()} for _ in range(2)]
    for lg in logs:
        assert all(np.isfinite(v) for v in lg.values()), lg
        assert lg["num_matched"] == 4
    assert logs[0]["loss"] != logs[1]["loss"]
    assert not torch.equal(model.camera_backbone.patch_embed.proj.weight, swin_before)
    assert opt.count == 2
