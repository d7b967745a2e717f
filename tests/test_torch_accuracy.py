"""Detection quality of the port: the overfit twin of tests/test_accuracy.py.

The same tiny scene (two frames of 2-3 cars sampled as 400 points each over
a ground layer, a 16 m x 16 m grid of 0.5 x 0.5 x 0.1 m voxels), the same
model widths (RPN 32 / 64, up 32 / 32, one car task), 600 train steps of the
same OneCycle AdamW schedule on one batch, and the same gates: kitti-style
AP40 ``mAP_bev >= 0.5`` and ``mAP_3d >= 0.3``, from raw points through the
port's device voxelizer (``ops/voxelize.py::voxelize_mean_grid``), its banded
backbone, RPN, head, decode and rotated NMS, and its ``kitti_eval``.

Two differences from JAX's test, both of the port: JAX's test runs its
``gather`` sparse engine, and this twin runs the port's banded engine, the
one the production configs name (the port's gather engine, JAX's default,
is held against JAX's in tests/test_torch_gather_backbone.py); and the
port's model starts from its own seeded init
(``models/builder.py::init_random_``), not flax's. Both leave the gates as
they are.

Runs on the card when there is one, else on the CPU (plain versions; a few
minutes). Slow lane only; ``chip_smoke.py`` runs the same scene on the card
and holds the detections against the plain versions."""
import numpy as np
import pytest
import torch

from dal3d_tpu_torch.core.anchors import generate_task_anchors
from dal3d_tpu_torch.core.box_coders import GroundBox3dCoder
from dal3d_tpu_torch.core.target_assigner import DeviceTargetAssigner
from dal3d_tpu_torch.eval.kitti_eval import kitti_eval
from dal3d_tpu_torch.models.builder import DetectorBundle, init_random_
from dal3d_tpu_torch.models.detectors.voxelnet import FPNVoxelNet
from dal3d_tpu_torch.models.heads.mg_head import LossConfig, TestConfig
from dal3d_tpu_torch.ops.voxelize import VoxelConfig
from dal3d_tpu_torch.runtime.steps import make_predict_step, make_train_step
from dal3d_tpu_torch.solver.optim import OneCycleSchedule, build_optimizer

pytestmark = [pytest.mark.slow, pytest.mark.overfit]

STEPS = 600
VCFG = VoxelConfig(
    point_cloud_range=(-8.0, -8.0, -3.0, 8.0, 8.0, 1.0),
    voxel_size=(0.5, 0.5, 0.1),  # grid 32x32x40 -> sparse (41,32,32)
    max_points_in_voxel=5,
    max_voxel_num=1000,
)
GENS = [
    dict(type="anchor_generator_range", sizes=[1.97, 4.63, 1.74],
         anchor_ranges=[-8, -8, -0.95, 8, 8, -0.95], rotations=[0, 1.57], velocities=[0, 0],
         matched_threshold=0.6, unmatched_threshold=0.45, class_name="car"),
]
TASKS = [dict(num_class=1, class_names=["car"])]


def make_bundle(device, seed: int = 0) -> DetectorBundle:
    coder = GroundBox3dCoder(vec_encode=True, n_dim=9)
    tas = generate_task_anchors(GENS, TASKS, [1, 4, 4])
    model = FPNVoxelNet(VCFG.sparse_shape, num_classes=(1,), rpn_ds_filters=(32, 64),
                        rpn_us_filters=(32, 32), brick_widths=(8, 8, 8, 4, 4),
                        banded_caps=(1024, 1024, 512, 256, 256), voxel_cfg=VCFG)
    init_random_(model, torch.Generator().manual_seed(seed))
    return DetectorBundle(
        model=model.to(device), voxel_cfg=VCFG, task_anchors=tas, box_coder=coder,
        assigner=DeviceTargetAssigner(tas, coder), loss_cfg=LossConfig(),
        test_cfg=TestConfig(nms_pre_max_size=32, nms_post_max_size=8, score_threshold=0.3),
        num_classes=(1,), device=torch.device(device))


def sample_box_points(rng, box, n):
    x, y, z, w, l, h = box[:6]
    yaw = box[8]
    local = rng.uniform(-0.5, 0.5, (n, 3)) * [w, l, h]
    c, s = np.cos(yaw), np.sin(yaw)
    return np.stack([
        local[:, 0] * c - local[:, 1] * s + x,
        local[:, 0] * s + local[:, 1] * c + y,
        local[:, 2] + z,
    ], 1)


def make_scene(seed, n_cars):
    """tests/test_accuracy.py's scene: (points [2600, 5], valid, gt [4, 9],
    classes [4])."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((4, 9), np.float32)
    cls = np.zeros((4,), np.int32)
    poses = [(-4.0, -3.5, 0.3), (3.5, 2.5, 1.2), (0.5, -4.5, -0.7), (-3.0, 4.0, 2.0)]
    pts_list = []
    for i in range(n_cars):
        x, y, yaw = poses[i]
        gt[i] = [x, y, -0.9, 1.97, 4.63, 1.74, 0, 0, yaw]
        cls[i] = 1
        pts_list.append(sample_box_points(rng, gt[i], 400))
    pts_list.append(np.stack([
        rng.uniform(-7.9, 7.9, 1200), rng.uniform(-7.9, 7.9, 1200),
        rng.uniform(-2.95, -2.5, 1200)], 1))
    xyz = np.concatenate(pts_list)
    P = 2600
    pts = np.zeros((P, 5), np.float32)
    n = min(len(xyz), P)
    pts[:n, :3] = xyz[:n]
    valid = np.zeros(P, bool)
    valid[:n] = True
    return pts, valid, gt, cls


def scene_batch():
    frames = [make_scene(s, n_cars=2 + s % 2) for s in range(2)]
    batch = {"points": np.stack([f[0] for f in frames]),
             "points_valid": np.stack([f[1] for f in frames]),
             "gt_boxes": [np.stack([f[2] for f in frames])],
             "gt_classes": [np.stack([f[3] for f in frames])]}
    return frames, batch


def detection_frames(frames, out):
    """(gt frames, predicted frames) of kitti_eval from the predict output."""
    gt_frames, pred_frames = [], []
    for b, f in enumerate(frames):
        gtb = f[2][f[3] > 0]
        gt_frames.append({"boxes": gtb, "names": np.array(["car"] * len(gtb)), "scores": None})
        v = out["det_valid"][b].astype(bool)
        pred_frames.append({"boxes": out["box3d_lidar"][b][v],
                            "names": np.array(["car"] * int(v.sum())),
                            "scores": out["scores"][b][v]})
    return gt_frames, pred_frames


def overfit(device, steps: int = STEPS):
    """Train the scene's batch ``steps`` times from raw points, predict it:
    (the last step's logs, the bundle, the batch, the predict output as host
    arrays, kitti_eval's results)."""
    frames, batch = scene_batch()
    bundle = make_bundle(device)
    opt = build_optimizer(OneCycleSchedule(lr_max=0.003, total_steps=steps)).init(
        bundle.model.named_parameters())
    step = make_train_step(bundle, opt)
    for _ in range(steps):
        logs = step(batch)
    predict = make_predict_step(bundle)
    out = predict({"points": batch["points"], "points_valid": batch["points_valid"]})
    out = {k: v.cpu().numpy() for k, v in out.items()}
    res = kitti_eval(*detection_frames(frames, out), ["car"], device=device)["results"]
    return {k: float(v) for k, v in logs.items()}, bundle, batch, out, res


# the twin through the port's CLIs: the scene as a 2-frame pool (one lidar
# file a frame, no sweeps) and the twin's model as a config
TWIN_PIPELINE = [dict(type="LoadPointCloudFromFile", dataset="NuScenesDataset"),
                 dict(type="LoadPointCloudAnnotations", with_bbox=True),
                 dict(type="Preprocess", cfg=dict(mode="val", shuffle_points=False)),
                 dict(type="ReformatFixedShape")]


def write_scene_pool(root: str) -> str:
    """The scene's two frames in the nuScenes infos schema under ``root``:
    each frame's valid points as a lidar file (x, y, z, 0, 0), no sweeps, its
    GT boxes. A config with ``nsweeps=1`` and raw points
    (``twin_config``) loads exactly ``scene_batch``'s points. Returns the
    infos path."""
    import os
    import pickle

    frames, _ = scene_batch()
    lidar_dir = os.path.join(root, "samples", "LIDAR_TOP")
    os.makedirs(lidar_dir, exist_ok=True)
    infos = []
    for b, (pts, valid, gt, cls) in enumerate(frames):
        token = f"twin{b}"
        path = os.path.join(lidar_dir, f"{token}.pcd.bin")
        pts[valid].astype(np.float32).tofile(path)
        boxes = gt[cls > 0]
        infos.append({
            "lidar_path": path, "token": token, "sweeps": [],
            "cam_front_path": os.path.join(
                root, "samples", "CAM_FRONT",
                f"n008-2018-01-01-00-00-00-0400__CAM_FRONT__{1531883530412470 + b}.jpg"),
            "ref_from_car": np.eye(4), "car_from_global": np.eye(4),
            "timestamp": 1531883530.412470 + b * 0.5, "gt_boxes": boxes,
            "gt_boxes_velocity": np.zeros((len(boxes), 3), np.float32),
            "gt_names": np.asarray(["car"] * len(boxes)),
            "gt_boxes_token": np.asarray([f"{token}_gt{i}" for i in range(len(boxes))])})
    info_path = os.path.join(root, "infos_train_twin.pkl")
    with open(info_path, "wb") as f:
        pickle.dump(infos, f)
    return info_path


def twin_config(info_path: str) -> dict:
    """``make_bundle``'s model, grid, anchors and test settings as a config
    of the port's builders (``build_detector`` builds the same module
    names and shapes), fed raw points from ``write_scene_pool``'s pool."""
    return dict(
        tasks=TASKS, target_assigner=dict(anchor_generators=GENS),
        box_coder=dict(type="ground_box3d_coder", n_dim=9, linear_dim=False,
                       encode_angle_vector=True),
        model=dict(type="FPNVoxelNet", reader=dict(num_input_features=5),
                   backbone=dict(impl="banded", dtype="float32", brick_widths=(8, 8, 8, 4, 4),
                                 banded_caps=(1024, 1024, 512, 256, 256)),
                   neck=dict(ds_num_filters=(32, 64), us_num_filters=(32, 32))),
        voxel_generator=dict(range=list(VCFG.point_cloud_range),
                             voxel_size=list(VCFG.voxel_size),
                             max_points_in_voxel=VCFG.max_points_in_voxel,
                             max_voxel_num=VCFG.max_voxel_num),
        voxelize_host=False,
        test_cfg=dict(nms=dict(nms_pre_max_size=32, nms_post_max_size=8),
                      score_threshold=0.3),
        max_points=2600,
        data=dict(samples_per_gpu=2, val=dict(
            type="NuScenesDataset", root_path="", info_path=info_path, nsweeps=1,
            class_names=["car"], test_mode=True, pipeline=TWIN_PIPELINE)))


def write_twin_config(path: str, info_path: str, **extra) -> str:
    """``twin_config`` as a config file, with ``extra`` top-level keys (a
    selector, a work_dir)."""
    with open(path, "w") as f:
        for k, v in {**twin_config(info_path), **extra}.items():
            f.write(f"{k} = {v!r}\n")
    return path


def test_overfit_reaches_detection_map():
    device = "cuda" if torch.cuda.is_available() else "cpu"
    logs, _, _, _, res = overfit(device)
    assert logs["loss"] < 0.05, logs  # overfit succeeded
    # BEV @0.7 IoU is the robust signal; 3D adds the z/h axis which the
    # 0.5m-voxel toy grid resolves more coarsely
    assert res["mAP_bev"] >= 0.5, res
    assert res["mAP_3d"] >= 0.3, res
