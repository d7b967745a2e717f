"""The port fed raw points, against JAX fed the same points, on the CPU.

Under a config with ``voxelize_host = False`` the loaders ship padded raw
points and the steps voxelize them on the device (dal3d_tpu_torch/ops/
voxelize.py::voxelize_mean_grid, JAX's ``sort_free_voxelize`` path). Held
here:

- the CBGS predict step from points against JAX's (the production config cut
  to a 12.8 m grid, tests/torch_port_utils.py::small_cfg, f32, weights
  carried by models/convert_flax.py): the embedding, the score entropy and
  the post-NMS detections as matched sets within 1e-4, as
  tests/test_torch_predict.py holds the host-voxel predict;
- one train step from points against JAX's: the five logs within 1e-4 of
  their scale;
- ``voxelize_host = False`` through the port's ``train``, ``dist_test`` and
  ``active_select`` CLIs, which ended in a KeyError on ``voxel_features``
  before the device voxelizer;
- the lidar-only BEVFusion predict from points against JAX's at the tiny
  config of tests/test_torch_bevfusion.py: query labels equal, boxes and
  scores within 1e-4 of scale."""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.models.bevfusion import BEVFusion as JaxBEVFusion
from dal3d_tpu.models.bevfusion import TransFusionTestCfg as JaxTestCfg
from dal3d_tpu.models.bevfusion import transfusion_decode as jax_decode
from dal3d_tpu.models.builder import build_detector as jax_build
from dal3d_tpu.ops.voxelize import VoxelConfig as JaxVoxelConfig
from dal3d_tpu.runtime.steps import TrainState
from dal3d_tpu.runtime.steps import make_predict_step as jax_make_predict_step
from dal3d_tpu.runtime.steps import make_train_step as jax_make_train_step
from dal3d_tpu.solver import optim as jo
from dal3d_tpu.utils.config import Config as JaxConfig
from dal3d_tpu_torch.data.datasets.synthetic import make_synthetic_nuscenes
from dal3d_tpu_torch.models.builder import build_bevfusion, build_detector
from dal3d_tpu_torch.models.convert_flax import load_flax_bevfusion, load_flax_variables
from dal3d_tpu_torch.runtime import checkpoint as ckpt
from dal3d_tpu_torch.runtime import evaluation as tev
from dal3d_tpu_torch.runtime.bevfusion_steps import make_bevfusion_predict_step
from dal3d_tpu_torch.runtime.steps import make_predict_step, make_train_step
from dal3d_tpu_torch.solver import optim as to
from dal3d_tpu_torch.tools import active_select, dist_test, train
from dal3d_tpu_torch.utils.config import Config
from dal3d_tpu_torch.utils.fileio import dump, load
from test_torch_bevfusion import TINY, VG, tiny_cfg
from test_torch_bevfusion import _randomize as bev_randomize
from test_torch_predict import _randomize
from test_torch_trainer import _write_cfg
from torch_port_utils import small_cfg, small_gt, small_voxels

ONE_CYCLE = dict(lr_max=0.002, moms=(0.95, 0.85), div_factor=10.0, pct_start=0.4, total_steps=100)
LOGS = ("loss", "grad_norm", "num_pos", "loc_loss", "cls_loss")
MAX_VOXELS = 1500


def raw_cfg():
    cfg = small_cfg("float32")
    cfg["voxel_generator"]["max_voxel_num"] = MAX_VOXELS
    return cfg


def small_points(seed, B=2, P=5000, N=1300, rng_xy=6.4, z0=-5.0, size=0.2):
    """Padded raw clouds [B, P, 5] f32 + validity [B, P] whose points fill the
    clustered voxels of ``small_voxels`` (1-4 points each, in a random
    order), with some points outside the grid and a padded invalid tail."""
    rng = np.random.RandomState(seed)
    vf, vc, vv = small_voxels(seed, B=B, N=N)
    pts = np.zeros((B, P, 5), np.float32)
    valid = np.zeros((B, P), bool)
    for b in range(B):
        c = vc[b][vv[b]]
        c = np.repeat(c, rng.randint(1, 5, len(c)), axis=0)
        xyz = (c[:, ::-1] + rng.uniform(0.05, 0.95, (len(c), 3))) * size
        xyz += [-rng_xy, -rng_xy, z0]
        p = np.concatenate([xyz, rng.uniform(0, 1, (len(c), 2))], 1)
        out = rng.uniform(-20, 20, (100, 5))
        out[:, 0] = rng.choice([-9.0, 9.0], 100)
        p = np.concatenate([p, out]).astype(np.float32)
        rng.shuffle(p)
        n = min(len(p), P)
        pts[b, :n], valid[b, :n] = p[:n], True
    return pts, valid


@pytest.fixture(scope="module")
def jax_cbgs():
    """JAX's f32 banded model on the small config, fed raw points: the
    variables, its predict step's output and one train step's logs."""
    cfg = raw_cfg()
    jb = jax_build(JaxConfig(cfg))
    pts, valid = small_points(0)
    gt_boxes, gt_classes = small_gt(cfg, 0)
    shapes = jax.eval_shape(lambda: jb.model.init(jax.random.PRNGKey(0), jnp.asarray(pts),
                                                  jnp.asarray(valid), False))
    variables = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape), shapes),
                           np.random.RandomState(1))
    pred = jax_make_predict_step(jb)(variables["params"], variables["batch_stats"],
                                     {"points": jnp.asarray(pts), "points_valid": jnp.asarray(valid)})
    optimizer = jo.build_optimizer(jo.OneCycleSchedule(**ONE_CYCLE), weight_decay=0.01,
                                   grad_clip_norm=35.0)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                       opt_state=optimizer.init(params))
    batch = {"points": jnp.asarray(pts), "points_valid": jnp.asarray(valid),
             "gt_boxes": [jnp.asarray(x) for x in gt_boxes],
             "gt_classes": [jnp.asarray(x) for x in gt_classes]}
    _, logs = jax_make_train_step(jb, optimizer)(state, batch)
    return (variables, {k: np.asarray(v) for k, v in pred.items()},
            {k: float(v) for k, v in logs.items()})


def test_predict_from_points_matches_jax(jax_cbgs):
    variables, jd, _ = jax_cbgs
    pts, valid = small_points(0)
    tb = build_detector(raw_cfg(), device="cpu")
    load_flax_variables(tb.model, variables)
    td = make_predict_step(tb)({"points": pts, "points_valid": valid})
    for b in range(2):
        jv, tv = jd["det_valid"][b], td["det_valid"][b].numpy()
        assert jv.sum() == tv.sum() > 5
        js, ts = jd["scores"][b][jv], td["scores"][b].numpy()[tv]
        jo_, to_ = np.argsort(-js, kind="stable"), np.argsort(-ts, kind="stable")
        assert len(np.unique(js)) == len(js)
        np.testing.assert_allclose(ts[to_], js[jo_], rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(td["label_preds"][b].numpy()[tv][to_],
                                      jd["label_preds"][b][jv][jo_])
        np.testing.assert_allclose(td["box3d_lidar"][b].numpy()[tv][to_],
                                   jd["box3d_lidar"][b][jv][jo_], rtol=1e-4, atol=1e-4)
    for k in ("embedding", "score_entropy"):
        np.testing.assert_allclose(td[k].numpy(), jd[k], rtol=1e-4, atol=1e-5, err_msg=k)
    # with host voxels of the same grid variant the step gives the same
    from dal3d_tpu_torch.ops.voxelize import voxelize_mean_grid

    vox = voxelize_mean_grid(torch.from_numpy(pts), torch.from_numpy(valid), tb.voxel_cfg)
    fed = make_predict_step(tb)({"voxel_features": vox["features"],
                                 "voxel_coords": vox["coordinates"],
                                 "voxel_valid": vox["voxel_valid"]})
    for k in ("box3d_lidar", "scores", "det_valid"):
        assert torch.equal(fed[k], td[k]), k


def test_train_step_from_points_matches_jax(jax_cbgs):
    variables, _, jlogs = jax_cbgs
    cfg = raw_cfg()
    pts, valid = small_points(0)
    gt_boxes, gt_classes = small_gt(cfg, 0)
    tb = build_detector(cfg, device="cpu")
    load_flax_variables(tb.model, variables)
    opt = to.build_optimizer(to.OneCycleSchedule(**ONE_CYCLE), weight_decay=0.01,
                             grad_clip_norm=35.0).init(tb.model.named_parameters())
    logs = make_train_step(tb, opt)({"points": pts, "points_valid": valid,
                                     "gt_boxes": gt_boxes, "gt_classes": gt_classes})
    assert jlogs["num_pos"] > 0
    for k in LOGS:
        assert float(logs[k]) == pytest.approx(jlogs[k], rel=1e-4, abs=1e-6), k


@pytest.fixture(scope="module")
def no_host_voxels(tmp_path_factory):
    """A synthetic labeled set and a config with ``voxelize_host = False``,
    trained for an epoch through the train CLI."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("raw_cli")
    info = make_synthetic_nuscenes(str(root), n_frames=4, n_logs=2, points_per_frame=3000,
                                   range_xy=6.0, max_boxes=6, seed=7)
    work = str(root / "work")
    cfg = _write_cfg(root / "cfg.py", info, work, voxelize_host=False)
    tr = train.main([cfg, "--work_dir", work, "--epochs", "1", "--no_validate", "--cpu",
                     "--seed", "0"])
    yield root, info, cfg, work, tr
    torch.set_num_threads(n)


def test_no_host_voxels_trains_tests_and_selects(no_host_voxels):
    root, info, cfg, work, tr = no_host_voxels
    assert tr.step >= 2 and os.path.exists(os.path.join(work, "checkpoints", "epoch_1.pth"))
    # the loaders ship raw points only
    dataset = tev.build_val_dataset(Config.fromfile(cfg))
    ex = dataset[0]
    ex = ex[0] if isinstance(ex, tuple) else ex
    assert "voxel_features" not in ex and ex["points"].shape == (40000, 5)

    out = str(root / "dets.pkl")
    np.random.seed(0)  # the sweep draw of a frame uses numpy's global generator
    result = dist_test.main([cfg, "--checkpoint", work, "--out", out, "--cpu",
                             "--work_dir", str(root / "eval")])
    assert set(result["kitti_style"]) == {"mAP_bev", "mAP_3d"}
    with open(out, "rb") as f:
        dets = pickle.load(f)
    assert list(dets) == [i["token"] for i in dataset.infos]
    # the CLI's detections are the predict step's on the loader's points
    bundle = build_detector(Config.fromfile(cfg), device="cpu")
    ckpt.load_checkpoint(work, bundle.model)
    from dal3d_tpu_torch.data import DataLoader

    np.random.seed(0)
    want = tev.predict_dataset(make_predict_step(bundle),
                               DataLoader(dataset, 2, shuffle=False, drop_last=False))
    for token, d in want.items():
        for k, v in d.items():
            np.testing.assert_array_equal(dets[token][k], v, err_msg=k)

    dump({"0": [0]}, os.path.join(work, "buffer.json"))
    active_select.main([cfg, "--checkpoint", work, "--cpu", "--seed", "1"])
    scores = dict(np.load(os.path.join(work, "pred.npz")))
    assert scores["embedding"].shape == (4, 512) and np.isfinite(scores["embedding"]).all()
    buf = load(os.path.join(work, "buffer.json"))
    assert len(buf) == 2 and len(buf["2"]) >= 2 and 0 in buf["2"]


def test_bevfusion_predict_from_points_matches_jax():
    vcfg = JaxVoxelConfig(tuple(VG["range"]), tuple(VG["voxel_size"]), 10, VG["max_voxel_num"])
    model = JaxBEVFusion(voxel_cfg=vcfg, with_camera=False, **TINY)
    pts, valid = small_points(3, N=1500)
    jbatch = {"points": jnp.asarray(pts), "points_valid": jnp.asarray(valid)}
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jbatch, False))
    variables = bev_randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                                     shapes), np.random.RandomState(7))
    preds = jax.jit(lambda v, b: model.apply(v, b, False))(variables, jbatch)
    tcfg = JaxTestCfg(out_size_factor=8, voxel_size=(0.2, 0.2), pc_range=(-6.4, -6.4))
    jdec = {k: np.asarray(v) for k, v in jax_decode(preds, tcfg).items()}

    bundle = build_bevfusion(tiny_cfg(), device="cpu")
    load_flax_bevfusion(bundle.model, variables)
    out = make_bevfusion_predict_step(bundle)({"points": pts, "points_valid": valid})
    np.testing.assert_array_equal(out["label_preds"].numpy(), jdec["label_preds"])
    np.testing.assert_array_equal(out["det_valid"].numpy(), jdec["det_valid"])
    for k in ("box3d_lidar", "scores"):
        ref = jdec[k]
        err = float(np.abs(out[k].numpy() - ref).max())
        assert err <= 1e-4 * max(float(np.abs(ref).max()), 1e-30), (k, err)
    assert float(out["scores"].max()) > 0
