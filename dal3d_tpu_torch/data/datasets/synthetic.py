"""Synthetic nuScenes-schema data generator, lidar only (port of
``dal3d_tpu/data/datasets/synthetic.py``: the same seed writes the same
points and infos).

Writes lidar .bin files + an infos .pkl with the exact reference info schema
(SURVEY.md A.1 / det3d/datasets/nuscenes/nusc_common.py:372-535): lidar_path,
cam_front_path (with the logfile name the selectors parse), token, sweeps,
ref_from_car, car_from_global, timestamp, gt_boxes [N,9], gt_names,
gt_boxes_velocity, gt_boxes_token — so the dataset / pipeline / selector
stack can be driven end-to-end without the real dataset.
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
) -> str:
    """Returns the written infos pkl path."""
    rng = np.random.RandomState(seed)
    classes = classes or DEFAULT_CLASSES
    lidar_dir = os.path.join(root, "samples", "LIDAR_TOP")
    os.makedirs(lidar_dir, exist_ok=True)

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
        })

    info_path = os.path.join(root, f"infos_{split}_10sweeps_withvelo.pkl")
    with open(info_path, "wb") as f:
        pickle.dump(infos, f)
    return info_path
