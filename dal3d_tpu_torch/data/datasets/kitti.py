"""KITTI dataset (port of ``dal3d_tpu/data/datasets/kitti.py``; the
reference's secondary dataset, det3d/datasets/kitti/).

Infos-pkl driven like the nuScenes path: each info carries
{velodyne_path, image_idx, calib{R0_rect, Tr_velo_to_cam, P2}, annos{name,
truncated, occluded, alpha, bbox, dimensions (l, h, w), location (camera),
rotation_y}}. The velodyne files hold 4 features a point; ``DontCare``
labels are dropped; boxes go from the camera frame to the lidar frame at
load; the ``LoadPointCloud*`` stages are skipped (the points are loaded
here) and the other stages are the nuScenes pipeline's. ``evaluation``
scores through ``eval/kitti_eval.py`` with the difficulty fields, on
``device`` (``None``: the CUDA card).
"""
from __future__ import annotations

import pickle
from typing import List, Optional

import numpy as np

from .nuscenes import build_pipeline


def camera_to_lidar_boxes(annos: dict, calib: dict) -> np.ndarray:
    """KITTI camera-frame boxes -> lidar [N, 9] (vx = vy = 0)."""
    loc = np.asarray(annos["location"], np.float64).reshape(-1, 3)
    dims = np.asarray(annos["dimensions"], np.float64).reshape(-1, 3)  # l, h, w
    ry = np.asarray(annos["rotation_y"], np.float64).reshape(-1)
    rect = np.asarray(calib["R0_rect"], np.float64)
    trv2c = np.asarray(calib["Tr_velo_to_cam"], np.float64)
    # cam -> lidar: x_l = inv(Tr) @ inv(R0) @ x_cam
    xyz1 = np.hstack([loc, np.ones((len(loc), 1))])
    xyz = (xyz1 @ np.linalg.inv(rect @ trv2c).T)[:, :3]
    l, h, w = dims[:, 0], dims[:, 1], dims[:, 2]
    zero = np.zeros_like(l)
    return np.stack([xyz[:, 0], xyz[:, 1], xyz[:, 2], w, l, h, zero, zero, -ry - np.pi / 2],
                    axis=1).astype(np.float32)


def _cared(annos: dict) -> dict:
    """The annotations without their ``DontCare`` rows."""
    keep = np.asarray([n != "DontCare" for n in annos["name"]], bool)
    return {k: np.asarray(v)[keep] for k, v in annos.items()}


class KittiDataset:
    NumPointFeatures = 4
    CLASSES = ("Car", "Pedestrian", "Cyclist")
    _SKIPPED = ("LoadPointCloudFromFile", "LoadPointCloudAnnotations")

    def __init__(self, info_path: str, root_path: str = "", class_names=None,
                 pipeline: Optional[List[dict]] = None, tasks=None,
                 test_mode: bool = False, max_points: int = 120000, **kwargs):
        with open(info_path, "rb") as f:
            self._infos = pickle.load(f)
        self._root = root_path
        self._class_names = list(class_names or self.CLASSES)
        self.test_mode = test_mode
        self.pipeline = (build_pipeline(pipeline, tasks=tasks, max_points=max_points)
                         if pipeline else [])

    @property
    def infos(self) -> List[dict]:
        return self._infos

    @property
    def class_names(self) -> List[str]:
        return self._class_names

    def __len__(self):
        return len(self._infos)

    def get_sensor_data(self, idx: int):
        info = self._infos[idx]
        points = np.fromfile(info["velodyne_path"], dtype=np.float32).reshape(-1, 4)
        res = {
            "lidar": {"type": "lidar", "nsweeps": 1, "points": points, "combined": points},
            "metadata": {"image_prefix": self._root, "num_point_features": 4,
                         "token": str(info.get("image_idx", idx))},
            "mode": "val" if self.test_mode else "train",
        }
        annos = info.get("annos")
        if annos is not None:
            sub = _cared(annos)
            res["lidar"]["annotations"] = {
                "boxes": camera_to_lidar_boxes(sub, info["calib"]),
                "names": sub["name"],
            }
        for stage in self.pipeline:
            if type(stage).__name__ not in self._SKIPPED:
                res, info = stage(res, info)
        return res

    def __getitem__(self, idx):
        return self.get_sensor_data(idx)

    def evaluation(self, detections, output_dir=".", device=None, **kwargs):
        """AP-40 BEV / 3D of padded detections (token -> box3d_lidar /
        scores / label_preds / det_valid) against the infos' labels, in the
        official easy / moderate / hard bins when the infos carry the
        difficulty fields; the IoUs run on ``device``."""
        from ...eval.kitti_eval import kitti_eval

        gt, preds = [], []
        for i, info in enumerate(self._infos):
            token = str(info.get("image_idx", i))
            sub = _cared(info.get("annos", {"name": []}))
            g = {"boxes": (camera_to_lidar_boxes(sub, info["calib"]) if len(sub["name"])
                           else np.zeros((0, 9), np.float32)),
                 "names": sub["name"]}
            if all(k in sub for k in ("bbox", "occluded", "truncated")):
                g["bbox"] = np.asarray(sub["bbox"], np.float32).reshape(-1, 4)
                g["occluded"] = np.asarray(sub["occluded"])
                g["truncated"] = np.asarray(sub["truncated"])
            gt.append(g)
            det = detections.get(token)
            if det is None:
                preds.append({"boxes": np.zeros((0, 9), np.float32), "names": np.asarray([]),
                              "scores": np.zeros((0,), np.float32)})
                continue
            valid = np.asarray(det["det_valid"]).astype(bool)
            labels = np.asarray(det["label_preds"])[valid]
            preds.append({
                "boxes": np.asarray(det["box3d_lidar"])[valid],
                "names": np.asarray([self._class_names[int(l)] for l in labels]),
                "scores": np.asarray(det["scores"])[valid],
            })
        return kitti_eval(gt, preds, self._class_names, device=device)
