"""Preprocess + fixed-shape formatting stages of the data path (port of
``dal3d_tpu/data/pipelines/preprocess.py``).

``Preprocess`` in train mode: class filter -> per-object noise -> flip /
rotation / scale -> point shuffle, every draw from numpy's global generator
in the JAX package's order; in val mode the optional point shuffle alone. The
GT-AUG paste (``db_sampler``) is not ported yet: as in the JAX package a
missing ``db_info_path`` means no sampler, an existing one raises here.
``ReformatFixedShape`` pads the points to a fixed shape, voxelizes on the host
(``core.voxel_generator``) and, in train mode, splits the GT boxes per task
into padded arrays with task-local class ids; sparse plans are built on the
GPU by the backbone, so no host plans are shipped.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

import os

from ...core import box_np_ops
from ...core.voxel_generator import points_to_voxel_mean
from . import augment


def _dict_select(d: dict, mask):
    for k, v in d.items():
        d[k] = v[mask]


class Preprocess:
    def __init__(self, cfg: dict, **kwargs):
        cfg = dict(cfg)
        self.mode = cfg["mode"]
        self.shuffle_points = cfg.get("shuffle_points", False)
        self.npoints = cfg.get("npoints", -1)
        if self.mode == "train":
            self.gt_rotation_noise = cfg.get("gt_rot_noise", [0.0, 0.0])
            self.gt_loc_noise_std = cfg.get("gt_loc_noise", [0.0, 0.0, 0.0])
            self.global_rotation_noise = cfg.get("global_rot_noise", [0.0, 0.0])
            self.global_scaling_noise = cfg.get("global_scale_noise", [1.0, 1.0])
            self.class_names = list(cfg["class_names"])
            self.min_points_in_gt = cfg.get("min_points_in_gt", -1)
            db_cfg = cfg.get("db_sampler", None)
            # the JAX package builds the sampler whenever its database file
            # exists (the enable flag is ignored) and goes without otherwise
            if db_cfg and os.path.exists(str(dict(db_cfg).get("db_info_path", ""))):
                raise NotImplementedError(
                    f"db_sampler with an existing database {dict(db_cfg)['db_info_path']!r}: "
                    "the GT-AUG sampler is not ported yet (ROADMAP A8)")

    def __call__(self, res: dict, info: dict):
        res["mode"] = self.mode
        points = res["lidar"]["combined"]

        if self.mode == "train":
            anno = res["lidar"]["annotations"]
            gt_dict = {
                "gt_boxes": np.asarray(anno["boxes"], np.float32).reshape(-1, 9),
                "gt_names": np.asarray(anno["names"]).reshape(-1),
            }
            if self.min_points_in_gt > 0:
                cnt = box_np_ops.points_in_rbbox(points, gt_dict["gt_boxes"]).sum(0)
                _dict_select(gt_dict, cnt >= self.min_points_in_gt)

            gt_boxes_mask = np.array(
                [n in self.class_names for n in gt_dict["gt_names"]], dtype=bool
            )
            augment.noise_per_object(
                gt_dict["gt_boxes"], points, gt_boxes_mask,
                rotation_perturb=self.gt_rotation_noise,
                center_noise_std=self.gt_loc_noise_std,
            )
            _dict_select(gt_dict, gt_boxes_mask)
            gt_dict["gt_classes"] = np.array(
                [self.class_names.index(n) + 1 for n in gt_dict["gt_names"]], np.int32
            )
            rec: dict = {}
            gt_dict["gt_boxes"], points = augment.random_flip_both(
                gt_dict["gt_boxes"], points, record=rec
            )
            gt_dict["gt_boxes"], points = augment.global_rotation(
                gt_dict["gt_boxes"], points, rotation=self.global_rotation_noise, record=rec
            )
            gt_dict["gt_boxes"], points = augment.global_scaling_v2(
                gt_dict["gt_boxes"], points, *self.global_scaling_noise, record=rec
            )
            res["lidar"]["annotations"] = gt_dict
            # composed lidar-frame augmentation (flip -> rot -> scale)
            A = np.eye(3, dtype=np.float64)
            if rec.get("flip_y"):
                A = np.diag([1.0, -1.0, 1.0]) @ A
            if rec.get("flip_x"):
                A = np.diag([-1.0, 1.0, 1.0]) @ A
            ang = rec.get("rotation", 0.0)
            c, s = np.cos(ang), np.sin(ang)
            A = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]]) @ A
            A = rec.get("scale", 1.0) * A
            res["lidar"]["aug_matrix"] = A.astype(np.float32)

        if self.shuffle_points:
            np.random.shuffle(points)
        res["lidar"]["points"] = points
        return res, info


class ReformatFixedShape:
    """Produce the fixed-shape example dict the steps consume: padded points
    [P_max, 5] + validity, with ``voxelize_host`` the mean voxel tensors
    (features [M, 5], coords [M, 3] (z, y, x), valid [M]), and in train mode
    per task ``gt_boxes`` [max_gt, 9] (yaw limited to [-pi, pi)) and
    ``gt_classes`` [max_gt] (task-local 1-based, 0 = pad)."""

    def __init__(self, tasks: Sequence[dict], max_points: int = 300000, max_gt: int = 128,
                 voxelize_host: Optional[dict] = None, **kwargs):
        self.tasks = [dict(t) for t in tasks]
        self.max_points = max_points
        self.max_gt = max_gt
        self.voxelize_host = dict(voxelize_host) if voxelize_host else None

    def __call__(self, res: dict, info: dict):
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

        if res.get("mode") == "train":
            gt = res["lidar"]["annotations"]
            boxes = gt["gt_boxes"]
            classes = gt["gt_classes"]  # global 1-based
            boxes = boxes.copy()
            boxes[:, -1] = box_np_ops.limit_period(boxes[:, -1], offset=0.5, period=2 * np.pi)
            gt_boxes_tasks, gt_classes_tasks = [], []
            flag = 0
            for t in self.tasks:
                nc = t["num_class"]
                mask = (classes > flag) & (classes <= flag + nc)
                tb = np.zeros((self.max_gt, 9), np.float32)
                tb[:, 3:6] = 1.0  # benign pad dims
                tc = np.zeros((self.max_gt,), np.int32)
                sel = np.flatnonzero(mask)[: self.max_gt]
                tb[: len(sel)] = np.nan_to_num(boxes[sel])
                tc[: len(sel)] = classes[sel] - flag  # task-local 1-based
                gt_boxes_tasks.append(tb)
                gt_classes_tasks.append(tc)
                flag += nc
            example["gt_boxes"] = gt_boxes_tasks
            example["gt_classes"] = gt_classes_tasks
        return example, info
