"""Synthetic nuScenes-schema data generator (port of
``dal3d_tpu/data/datasets/synthetic.py``: the same seed writes the same
points, infos and camera frames).

Writes lidar .bin files + an infos .pkl with the exact reference info schema
(SURVEY.md A.1 / det3d/datasets/nuscenes/nusc_common.py:372-535): lidar_path,
cam_front_path (with the logfile name the selectors parse), token, sweeps,
ref_from_car, car_from_global, timestamp, gt_boxes [N,9], gt_names,
gt_boxes_velocity, gt_boxes_token — so the dataset / pipeline / selector
stack can be driven end-to-end without the real dataset. ``with_camera``
adds six ring cameras per frame ("cams": a JPEG each, written by PIL, with
its intrinsics and camera-to-lidar extrinsics).
"""
from __future__ import annotations

import os
import pickle
from typing import List, Optional

import numpy as np

DEFAULT_CLASSES = [
    "car", "truck", "construction_vehicle", "bus", "trailer",
    "barrier", "motorcycle", "bicycle", "pedestrian", "traffic_cone",
]
_SIZES = {
    "car": [1.97, 4.63, 1.74], "truck": [2.51, 6.93, 2.84],
    "construction_vehicle": [2.85, 6.37, 3.19], "bus": [2.94, 10.5, 3.47],
    "trailer": [2.90, 12.29, 3.87], "barrier": [2.53, 0.50, 0.98],
    "motorcycle": [0.77, 2.11, 1.47], "bicycle": [0.60, 1.70, 1.28],
    "pedestrian": [0.67, 0.73, 1.77], "traffic_cone": [0.41, 0.41, 1.07],
}


def make_synthetic_nuscenes(
    root: str,
    n_frames: int = 8,
    n_logs: int = 2,
    points_per_frame: int = 20000,
    max_boxes: int = 12,
    nsweeps_stored: int = 9,
    classes: Optional[List[str]] = None,
    seed: int = 0,
    split: str = "train",
    range_xy: float = 45.0,
    with_camera: bool = False,
    image_hw: tuple = (64, 96),
    cam_names: tuple = (
        "CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
        "CAM_BACK_LEFT", "CAM_BACK", "CAM_BACK_RIGHT",
    ),
) -> str:
    """Returns the written infos pkl path."""
    rng = np.random.RandomState(seed)
    classes = classes or DEFAULT_CLASSES
    lidar_dir = os.path.join(root, "samples", "LIDAR_TOP")
    os.makedirs(lidar_dir, exist_ok=True)

    def _make_cams(token: str) -> dict:
        """The ring cameras at the ego origin (nuScenes infos "cams" schema:
        data_path, camera_intrinsics, sensor2lidar_rotation / translation)."""
        from PIL import Image

        iH, iW = image_hw
        cams = {}
        for ci, name in enumerate(cam_names):
            cdir = os.path.join(root, "samples", name)
            os.makedirs(cdir, exist_ok=True)
            path = os.path.join(cdir, f"{token}_{name}.jpg")
            img = (rng.rand(iH, iW, 3) * 80 + 80).astype(np.uint8)
            img[:, :, 0] = np.linspace(0, 255, iW, dtype=np.uint8)[None, :]
            Image.fromarray(img).save(path)
            yaw = 2 * np.pi * ci / len(cam_names)
            c, s = np.cos(yaw), np.sin(yaw)
            # camera optical frame (x right, y down, z forward) -> lidar:
            # base (yaw 0, looking along lidar +x), then a rotation about z
            base = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
            rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
            cams[name] = {
                "data_path": path,
                "camera_intrinsics": np.array(
                    [[50.0, 0.0, iW / 2], [0.0, 50.0, iH / 2], [0.0, 0.0, 1.0]]),
                "sensor2lidar_rotation": rz @ base,
                "sensor2lidar_translation": np.array([0.0, 0.0, 1.6]),
            }
        return cams

    infos = []
    logs = [f"n008-2018-0{i+1}-01-00-00-00-0400" for i in range(n_logs)]
    for fi in range(n_frames):
        log = logs[fi * n_logs // n_frames]
        token = f"synthtoken{fi:06d}"
        # points: ground plane + object clusters, stored as [N, 5] float32
        n_bg = points_per_frame
        pts = np.zeros((n_bg, 5), np.float32)
        pts[:, 0] = rng.uniform(-range_xy - 5, range_xy + 5, n_bg)
        pts[:, 1] = rng.uniform(-range_xy - 5, range_xy + 5, n_bg)
        pts[:, 2] = rng.uniform(-1.8, -1.5, n_bg)
        pts[:, 3] = rng.uniform(0, 255, n_bg)

        n_box = rng.randint(2, max_boxes + 1)
        names, boxes = [], []
        for b in range(n_box):
            cname = classes[rng.randint(len(classes))]
            w, l, h = _SIZES[cname]
            cx, cy = rng.uniform(-range_xy, range_xy, 2)
            cz = -1.6
            yaw = rng.uniform(-np.pi, np.pi)
            vx, vy = rng.uniform(-2, 2, 2)
            boxes.append([cx, cy, cz, w, l, h, vx, vy, yaw])
            names.append(cname)
            # cluster of surface points
            npts = rng.randint(20, 80)
            local = rng.uniform(-0.5, 0.5, (npts, 3)) * np.array([w, l, h])
            c, s = np.cos(yaw), np.sin(yaw)
            rot = np.array([[c, -s], [s, c]])
            obj = np.zeros((npts, 5), np.float32)
            obj[:, :2] = local[:, :2] @ rot + np.array([cx, cy])
            obj[:, 2] = cz + h / 2 + local[:, 2] / 2
            obj[:, 3] = rng.uniform(0, 255, npts)
            pts = np.concatenate([pts, obj], axis=0)

        lidar_path = os.path.join(lidar_dir, f"{token}.pcd.bin")
        pts.astype(np.float32).tofile(lidar_path)

        # ego pose: frames move along a line per log
        ego_xy = np.array([fi * 10.0, (fi % n_logs) * 100.0])
        car_from_global = np.eye(4)
        car_from_global[:3, 3] = [-ego_xy[0], -ego_xy[1], 0.0]

        infos.append({
            "lidar_path": lidar_path,
            "cam_front_path": os.path.join(
                root, "samples", "CAM_FRONT",
                f"{log}__CAM_FRONT__{1531883530412470 + fi}.jpg",
            ),
            "token": token,
            "sweeps": [
                {
                    "lidar_path": lidar_path,
                    "sample_data_token": f"{token}_sweep{k}",
                    "transform_matrix": np.eye(4),
                    "time_lag": 0.05 * (k + 1),
                }
                for k in range(nsweeps_stored)
            ],
            "ref_from_car": np.eye(4),
            "car_from_global": car_from_global,
            "timestamp": 1531883530.412470 + fi * 0.5,
            "gt_boxes": np.asarray(boxes, np.float32),
            "gt_boxes_velocity": np.concatenate(
                [np.asarray(boxes, np.float32)[:, 6:8], np.zeros((n_box, 1), np.float32)], axis=1
            ),
            "gt_names": np.asarray(names),
            "gt_boxes_token": np.asarray([f"{token}_gt{b}" for b in range(n_box)]),
            **({"cams": _make_cams(token)} if with_camera else {}),
        })

    info_path = os.path.join(root, f"infos_{split}_10sweeps_withvelo.pkl")
    with open(info_path, "wb") as f:
        pickle.dump(infos, f)
    return info_path


# a fixed KITTI-like calibration: camera x = -lidar y, camera y = -lidar z,
# camera z = lidar x, the camera 0.27 m behind and 0.08 m below the lidar
KITTI_CALIB = {
    "R0_rect": np.eye(4),
    "Tr_velo_to_cam": np.array([[0.0, -1.0, 0.0, 0.0], [0.0, 0.0, -1.0, -0.08],
                                [1.0, 0.0, 0.0, -0.27], [0.0, 0.0, 0.0, 1.0]]),
    "P2": np.array([[721.5, 0.0, 609.6, 44.9], [0.0, 721.5, 172.9, 0.2],
                    [0.0, 0.0, 1.0, 0.003], [0.0, 0.0, 0.0, 1.0]]),
}


def make_synthetic_kitti(nusc_info_path: str, root: str) -> str:
    """The scenes of a nuScenes-schema set (``make_synthetic_nuscenes``,
    ``create_data synthetic_data_prep``) as a KITTI set: 4-feature velodyne
    files of the keyframes' points, and infos with the KITTI calibration and
    camera-frame labels (location, dimensions (l, h, w), rotation_y =
    -yaw - pi/2; every box easy: a 50 px tall image box, not truncated or
    occluded), plus one ``DontCare`` label a frame. The inverse of
    ``kitti.py::camera_to_lidar_boxes``. Returns the written infos pkl path."""
    calib = {k: np.asarray(v, np.float64) for k, v in KITTI_CALIB.items()}
    with open(nusc_info_path, "rb") as f:
        nusc = pickle.load(f)
    vel_dir = os.path.join(root, "training", "velodyne")
    os.makedirs(vel_dir, exist_ok=True)
    to_cam = calib["R0_rect"] @ calib["Tr_velo_to_cam"]
    infos = []
    for i, info in enumerate(nusc):
        pts = np.fromfile(info["lidar_path"], dtype=np.float32).reshape(-1, 5)[:, :4]
        path = os.path.join(vel_dir, f"{i:06d}.bin")
        np.ascontiguousarray(pts).tofile(path)
        boxes = np.asarray(info["gt_boxes"], np.float64).reshape(-1, 9)
        n = len(boxes)
        loc = (np.hstack([boxes[:, :3], np.ones((n, 1))]) @ to_cam.T)[:, :3]
        names = list(np.asarray(info["gt_names"])) + ["DontCare"]
        annos = {
            "name": np.asarray(names),
            "truncated": np.zeros(n + 1),
            "occluded": np.zeros(n + 1, np.int64),
            "alpha": np.zeros(n + 1),
            "bbox": np.tile([100.0, 100.0, 160.0, 150.0], (n + 1, 1)),
            "dimensions": np.vstack([boxes[:, [4, 5, 3]], [[1.0, 1.0, 1.0]]]),
            "location": np.vstack([loc, [[0.0, -1000.0, 0.0]]]),
            "rotation_y": np.append(-boxes[:, 8] - np.pi / 2, 0.0),
        }
        infos.append({"image_idx": i, "velodyne_path": path, "calib": calib, "annos": annos})
    info_path = os.path.join(root, "kitti_infos_train.pkl")
    with open(info_path, "wb") as f:
        pickle.dump(infos, f)
    return info_path
