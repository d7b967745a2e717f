"""Port parity for the slice as a whole: the lidar-only BEVFusion
(TransFusion-L) predict of dal3d_tpu_torch against dal3d_tpu on the same host
voxels and weights, on the CPU.

The model is the tiny one of __graft_entry__.py (num_proposals 8, decoder
(16, 32) x (1, 1), neck (16, 16), hidden 16, FFN 32, 2 heads, caps (2000,
1000, 500, 500)) on a 12.8 m grid at 0.2 m (sparse shape (41, 64, 64)), B=2.
JAX initialises it (jitted: eager ``apply`` is several times slower); its
variables are randomised with numpy so that activations, BN statistics and
scores spread out, and carried across by the weights bridge
(models/convert_flax.py::load_flax_bevfusion). Required: the lidar BEV map,
the decoder map and the heatmap within 1e-4 of their scale; the query labels
and query pixels equal; decoded boxes and scores within 1e-4."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.models.bevfusion import BEVFusion as JaxBEVFusion
from dal3d_tpu.models.bevfusion import TransFusionTestCfg as JaxTestCfg
from dal3d_tpu.models.bevfusion import transfusion_decode as jax_decode
from dal3d_tpu.ops.voxelize import VoxelConfig as JaxVoxelConfig
from dal3d_tpu_torch.data.datasets.nuscenes import NuScenesDataset
from dal3d_tpu_torch.data.datasets.synthetic import make_synthetic_nuscenes
from dal3d_tpu_torch.data.loader import DataLoader
from dal3d_tpu_torch.models.builder import build_bevfusion
from dal3d_tpu_torch.models.convert_flax import (bevfusion_flax_to_state_dict,
                                                 load_flax_bevfusion)
from dal3d_tpu_torch.ops import gather as tg
from dal3d_tpu_torch.runtime.bevfusion_steps import make_bevfusion_predict_step
from dal3d_tpu_torch.utils.config import Config
from torch_port_utils import small_voxels

TINY = dict(num_proposals=8, decoder_channels=(16, 32), decoder_layer_nums=(1, 1),
            neck_out_channels=(16, 16), hidden_channel=16, ffn_channel=32, num_heads=2,
            voxel_caps=(2000, 1000, 500, 500))
VG = dict(range=[-6.4, -6.4, -5.0, 6.4, 6.4, 3.0], voxel_size=[0.2, 0.2, 0.2],
          max_points_in_voxel=10, max_voxel_num=1800)
TEST_CFG = dict(out_size_factor=8, voxel_size=[0.2, 0.2], pc_range=[-6.4, -6.4])
CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def tiny_cfg(**model):
    return {"model": {"type": "BEVFusion", "with_camera": False, **TINY, **model},
            "voxel_generator": dict(VG), "test_cfg": dict(TEST_CFG)}


def _randomize(tree, rng, path=""):
    """Seeded numpy values for every leaf: kernels ~ N(0, 2/fan_in), biases
    ~ 0.05 N(0, 1), norm scale/bias and BN mean/var near the identity with
    10-20 % spread."""
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
        else:
            x = 0.05 * rng.randn(*shape)
        out[k] = x.astype(np.float32)
    return out


def _jax_query_pixels(heatmap, P):
    """The JAX head's query pixels, from its heatmap with its own ops (local-
    max NMS, padding ring out, classes 8 and 9 raw, lax.top_k over the
    class-major flatten)."""
    B, H, W, nc = heatmap.shape
    prob = jax.nn.sigmoid(heatmap)
    pooled = jax.lax.reduce_window(prob, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 1, 1, 1),
                                   "SAME")
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    inner = (yy >= 1) & (yy < H - 1) & (xx >= 1) & (xx < W - 1)
    local_max = jnp.where(inner[None, :, :, None], pooled, 0.0)
    local_max = jnp.where((np.arange(nc) >= 8)[None, None, None, :], prob, local_max)
    masked = prob * (prob == local_max)
    _, top = jax.lax.top_k(masked.transpose(0, 3, 1, 2).reshape(B, -1), P)
    return np.asarray(top % (H * W))


@pytest.fixture(scope="module")
def jax_ref():
    """(batch, variables, JAX's preds, decoded output, lidar map, query
    pixels) of the tiny model."""
    vcfg = JaxVoxelConfig(tuple(VG["range"]), tuple(VG["voxel_size"]), 10, VG["max_voxel_num"])
    model = JaxBEVFusion(voxel_cfg=vcfg, with_camera=False, **TINY)
    vf, vc, vv = small_voxels(0, N=1800)
    batch = {"voxel_features": vf, "voxel_coords": vc, "voxel_valid": vv}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jb, False))
    variables = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes),
                           np.random.RandomState(7))
    preds = jax.jit(lambda v, b: model.apply(v, b, False))(variables, jb)
    lidar = jax.jit(lambda v, b: model.apply(v, b, False, stop_at="lidar"))(variables, jb)
    tcfg = JaxTestCfg(out_size_factor=8, voxel_size=(0.2, 0.2), pc_range=(-6.4, -6.4))
    dec = jax_decode(preds, tcfg)
    to_np = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return (batch, variables, to_np(preds), to_np(dec), np.asarray(lidar["lidar"]),
            _jax_query_pixels(preds["heatmap"], TINY["num_proposals"]))


@pytest.fixture(scope="module")
def port(jax_ref):
    """The port's bundle with JAX's weights, its predict output and the query
    rows its row gather took."""
    batch, variables = jax_ref[:2]
    bundle = build_bevfusion(tiny_cfg(), device="cpu")
    load_flax_bevfusion(bundle.model, variables)
    calls = []
    orig = tg.gather_rows

    def spy(table, idx):
        calls.append(idx.clone())
        return orig(table, idx)

    tg.gather_rows = spy
    try:
        out = make_bevfusion_predict_step(bundle)(batch)
        with torch.inference_mode():
            preds = bundle.model(*[torch.from_numpy(batch[k]) for k in
                                   ("voxel_features", "voxel_coords", "voxel_valid")])
            voxels = [torch.from_numpy(batch[k])
                      for k in ("voxel_features", "voxel_coords", "voxel_valid")]
            lidar = bundle.model(*voxels, stop_at="lidar")["lidar"]
            decoder = bundle.model(*voxels, stop_at="decoder")["decoder"]
    finally:
        tg.gather_rows = orig
    assert torch.equal(decoder, preds["bev_feat"])
    return bundle, out, preds, lidar, calls


def _close(got, ref, rel=1e-4):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert got.shape == ref.shape and err <= rel * scale, (err, scale)


def test_maps_match_jax(jax_ref, port):
    _, _, jp, _, jlidar, _ = jax_ref
    _, _, preds, lidar, _ = port
    assert jlidar.shape == (2, 8, 8, 256)
    _close(lidar, jlidar)
    _close(preds["bev_feat"], jp["bev_feat"])
    _close(preds["heatmap"], jp["heatmap"])
    assert float(np.abs(jp["heatmap"]).max()) > 0.1


def test_queries_match_jax(jax_ref, port):
    _, _, jp, _, _, jpix = jax_ref
    _, _, preds, _, calls = port
    np.testing.assert_array_equal(preds["query_labels"].numpy(), jp["query_labels"])
    HW = 8 * 8
    pix = (calls[0].long().view(2, -1) - torch.arange(2)[:, None] * HW).numpy()
    np.testing.assert_array_equal(pix, jpix)
    _close(preds["query_score"], jp["query_score"])
    for k in ("center", "height", "dim", "rot", "vel", "cls_logits"):
        _close(preds[k], jp[k])


def test_decoded_detections_match_jax(jax_ref, port):
    jdec = jax_ref[3]
    out = port[1]
    assert set(out) == {"box3d_lidar", "scores", "label_preds", "det_valid", "bev_feat"}
    assert out["box3d_lidar"].shape == (2, 8, 9)
    box, ref = out["box3d_lidar"].numpy(), jdec["box3d_lidar"]
    assert np.all(np.abs(box - ref) <= 1e-4 * np.maximum(np.abs(ref), 1.0))
    np.testing.assert_allclose(out["scores"].numpy(), jdec["scores"], rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(out["label_preds"].numpy(), jdec["label_preds"])
    np.testing.assert_array_equal(out["det_valid"].numpy(), jdec["det_valid"])


def test_bridge_is_strict_both_ways(jax_ref, port):
    """Every flax leaf lands in exactly one entry, every port parameter and
    buffer is covered; a missing leaf raises."""
    variables = jax_ref[1]
    model = port[0].model
    leaves = len(jax.tree_util.tree_leaves(variables))
    sd = bevfusion_flax_to_state_dict(variables, model)
    assert len(sd) == leaves == len(model.state_dict())
    params = dict(variables["params"])
    params["TransFusionHead_0"] = {k: v for k, v in params["TransFusionHead_0"].items()
                                   if k != "pred_vel"}
    with pytest.raises(KeyError):
        bevfusion_flax_to_state_dict({"params": params,
                                      "batch_stats": variables["batch_stats"]}, model)


def test_build_from_config_file_and_what_raises(tmp_path):
    cfg_file = tmp_path / "bevfusion_tiny.py"
    cfg_file.write_text(f"model = {tiny_cfg()['model']!r}\nvoxel_generator = {VG!r}\n"
                        f"test_cfg = {TEST_CFG!r}\n")
    bundle = build_bevfusion(Config.fromfile(str(cfg_file)), device="cpu", seed=3)
    assert bundle.voxel_cfg.sparse_shape == (41, 64, 64)
    assert bundle.test_cfg.voxel_size == (0.2, 0.2) and bundle.test_cfg.out_size_factor == 8
    assert not bundle.model.training
    camera = build_bevfusion(tiny_cfg(with_camera=True, image_size=(32, 48)), device="cpu")
    assert camera.model.with_camera and camera.model.fuser is not None
    assert type(camera.model.camera_vtransform).__name__ == "DepthLSSTransform"
    # the A10.c heads build (tests/test_torch_bevfusion_centerpoint.py and
    # test_torch_bevfusion_seg.py hold them against JAX's); an unknown head raises
    center = build_bevfusion(tiny_cfg(head="centerpoint"), device="cpu")
    assert center.model.head_type == "centerpoint" and len(center.model.head.tasks) == 6
    assert center.test_cfg.max_per_task == 83 and center.test_cfg.pc_range == (-6.4, -6.4)
    seg = build_bevfusion(tiny_cfg(with_map_seg=True), device="cpu")
    assert seg.model.seg_head is not None and len(seg.model.seg_head.classes) == 6
    with pytest.raises(ValueError, match="unknown head"):
        build_bevfusion(tiny_cfg(head="anchor3d"), device="cpu")
    step = make_bevfusion_predict_step(bundle)
    # raw points, refused before the device voxelizer, now run: voxelized at
    # the config's grid, they give what their host-free grid voxels give
    rng = np.random.RandomState(4)
    pts = np.concatenate([rng.uniform(-6, 6, (1, 400, 2)), rng.uniform(-4, 2, (1, 400, 1)),
                          rng.uniform(0, 1, (1, 400, 2))], -1).astype(np.float32)
    raw = step({"points": pts, "points_valid": np.ones((1, 400), bool)})
    from dal3d_tpu_torch.ops.voxelize import voxelize_mean_grid

    vox = voxelize_mean_grid(torch.from_numpy(pts), torch.ones(1, 400, dtype=torch.bool),
                             bundle.voxel_cfg)
    fed = step({"voxel_features": vox["features"], "voxel_coords": vox["coordinates"],
                "voxel_valid": vox["voxel_valid"]})
    assert int(vox["num_voxels"][0]) > 300
    for k in ("box3d_lidar", "scores", "label_preds", "det_valid"):
        assert torch.equal(raw[k], fed[k]), k
    vf, vc, vv = small_voxels(1, B=1, N=200)
    bundle.model.train()  # train mode runs (batch statistics; the step is tested elsewhere)
    preds = bundle.model(torch.from_numpy(vf), torch.from_numpy(vc), torch.from_numpy(vv))
    assert preds["heatmap"].requires_grad and bool(torch.isfinite(preds["heatmap"]).all())
    bundle.model.eval()
    vc[0, 0] = (41, 0, 0)  # outside the grid
    with pytest.raises(ValueError, match="outside the grid"):
        step({"voxel_features": vf, "voxel_coords": vc, "voxel_valid": vv})


def test_production_config_builds_at_full_width():
    """configs/bevfusion_lidar.py: (41, 1440, 1440) grid, caps (120000,
    60000, 30000, 30000), 512-wide neck, 200 proposals (no forward: the full
    size runs on the card)."""
    bundle = build_bevfusion(Config.fromfile(os.path.join(CONFIGS, "bevfusion_lidar.py")),
                             device="cpu")
    m = bundle.model
    assert bundle.voxel_cfg.sparse_shape == (41, 1440, 1440)
    assert bundle.voxel_cfg.max_voxel_num == 120000
    assert [s.down.out_cap for s in m.encoder.stages[:3]] == [120000, 60000, 30000]
    assert m.encoder.conv_out.out_cap == 30000
    assert m.decoder.blocks[0][0].weight.shape == (128, 256, 3, 3)
    assert m.head.shared_conv.weight.shape == (128, 512, 3, 3)
    assert m.head.num_proposals == 200 and m.head.decoder0.self_attn.heads == 8


def test_loader_fed_predict(tmp_path):
    """Frames of the synthetic nuScenes infos through the production test
    pipeline (host mean voxelizer, voxelize_host = the voxel generator), cut
    to the tiny grid, and the loader, into the predict step."""
    info = make_synthetic_nuscenes(str(tmp_path), n_frames=4, n_logs=1, points_per_frame=3000,
                                   seed=0, range_xy=6.0)
    cfg = Config.fromfile(os.path.join(CONFIGS, "bevfusion_lidar.py"))
    val = cfg["data"]["val"]
    ds = NuScenesDataset(info_path=info, root_path=str(tmp_path), nsweeps=val["nsweeps"],
                         class_names=val["class_names"], test_mode=True,
                         pipeline=[dict(s) for s in val["pipeline"]],
                         tasks=[dict(t) for t in cfg["tasks"]], max_points=20000,
                         voxelize_host=dict(VG))
    step = make_bevfusion_predict_step(build_bevfusion(tiny_cfg(), device="cpu"))
    n = 0
    for batch in DataLoader(ds, batch_size=2, shuffle=False, drop_last=False, prefetch=0):
        assert batch["voxel_features"].shape == (2, VG["max_voxel_num"], 5)
        assert batch["voxel_valid"].sum() > 100
        out = step(batch)
        assert out["box3d_lidar"].shape == (2, 8, 9)
        assert torch.isfinite(out["box3d_lidar"]).all() and out["det_valid"].any()
        n += 2
    assert n == 4
