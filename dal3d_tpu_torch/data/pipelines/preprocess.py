"""Preprocess + fixed-shape formatting stages of the pool's data path (port
of ``dal3d_tpu/data/pipelines/preprocess.py``, test mode).

``Preprocess`` runs its val branch (optional point shuffle); the train branch
(class filter, GT paste, noise, flip / rotation / scale) belongs to the
training slice. ``ReformatFixedShape`` pads the points to a fixed shape and
voxelizes on the host (``core.voxel_generator``); sparse plans are built on
the GPU by the backbone, so no host plans are shipped.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ...core.voxel_generator import points_to_voxel_mean


class Preprocess:
    def __init__(self, cfg: dict, **kwargs):
        cfg = dict(cfg)
        self.mode = cfg["mode"]
        if self.mode == "train":
            raise NotImplementedError("train-mode preprocessing is not ported yet "
                                      "(augmentation comes with the training slice)")
        self.shuffle_points = cfg.get("shuffle_points", False)
        self.npoints = cfg.get("npoints", -1)

    def __call__(self, res: dict, info: dict):
        res["mode"] = self.mode
        points = res["lidar"]["combined"]
        if self.shuffle_points:
            np.random.shuffle(points)
        res["lidar"]["points"] = points
        return res, info


class ReformatFixedShape:
    """Produce the fixed-shape example dict the predict step consumes:
    padded points [P_max, 5] + validity, and with ``voxelize_host`` the mean
    voxel tensors (features [M, 5], coords [M, 3] (z, y, x), valid [M])."""

    def __init__(self, tasks: Sequence[dict], max_points: int = 300000, max_gt: int = 128,
                 voxelize_host: Optional[dict] = None, **kwargs):
        self.tasks = [dict(t) for t in tasks]
        self.max_points = max_points
        self.max_gt = max_gt
        self.voxelize_host = dict(voxelize_host) if voxelize_host else None

    def __call__(self, res: dict, info: dict):
        if res.get("mode") == "train":
            raise NotImplementedError("train-mode targets are not ported yet")
        points = res["lidar"]["points"]
        P = self.max_points
        n = min(len(points), P)
        pts = np.zeros((P, points.shape[1]), np.float32)
        pts[:n] = points[:n]
        valid = np.zeros(P, bool)
        valid[:n] = True
        example = {
            "points": pts,
            "points_valid": valid,
            "metadata": res.get("metadata", {}),
        }
        if self.voxelize_host is not None:
            vh = self.voxelize_host
            M = int(vh["max_voxel_num"])
            # opt-in: halves the host-to-device voxel payload but quantizes
            # the mean features to bfloat16
            bf16 = bool(vh.get("bf16", False))
            feats, coords, _ = points_to_voxel_mean(
                points[: self.max_points].astype(np.float32), vh["voxel_size"], vh["range"],
                int(vh["max_points_in_voxel"]), M, bf16=bf16)
            n = feats.shape[0]
            if bf16:
                feat = torch.zeros((M, points.shape[1]), dtype=torch.bfloat16)
            else:
                feat = np.zeros((M, points.shape[1]), np.float32)
            feat[:n] = feats
            vcoords = np.zeros((M, 3), np.int32)
            vcoords[:n] = coords
            vvalid = np.zeros((M,), bool)
            vvalid[:n] = True
            example["voxel_features"] = feat
            example["voxel_coords"] = vcoords
            example["voxel_valid"] = vvalid
        return example, info
