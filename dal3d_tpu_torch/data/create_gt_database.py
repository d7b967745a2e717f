"""GT database creation for the GT-AUG paste augmentation (port of
``dal3d_tpu/data/create_gt_database.py``; host numpy, as there).

For each frame of the (possibly AL-selected) infos, crop each GT box's
interior points (``points_in_rbbox``), write them as
``gt_database_<n>sweeps_withvelo[_suffix]/<idx>_<name>_<i>.bin`` and record
db infos {name, path, image_idx, gt_idx, box3d_lidar, num_points_in_gt,
difficulty, group_id} into ``dbinfos_train_<n>sweeps_withvelo[_suffix].pkl``.
The suffixed database is built from the AL-selected subset, so that GT-AUG
pastes only labeled objects.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from ..core import box_np_ops
from ..utils.fileio import load
from .pipelines.loading import read_file, read_sweep


def create_groundtruth_database(
    root_path: str,
    info_path: str,
    used_classes=None,
    db_path: Optional[str] = None,
    dbinfo_path: Optional[str] = None,
    nsweeps: int = 10,
    suffix: Optional[str] = None,
) -> str:
    infos = load(info_path)
    tag = f"gt_database_{nsweeps}sweeps_withvelo" + (f"_{suffix}" if suffix else "")
    db_path = db_path or os.path.join(root_path, tag)
    dbinfo_path = dbinfo_path or os.path.join(
        root_path, f"dbinfos_train_{nsweeps}sweeps_withvelo" + (f"_{suffix}" if suffix else "") + ".pkl"
    )
    os.makedirs(db_path, exist_ok=True)

    all_db_infos: dict = {}
    group_counter = 0
    for idx, info in enumerate(infos):
        points = read_file(str(info["lidar_path"]))
        sweep_points = [points]
        times = [np.zeros((points.shape[0], 1))]
        for i in range(min(nsweeps - 1, len(info.get("sweeps", [])))):
            ps, ts = read_sweep(info["sweeps"][i])
            sweep_points.append(ps)
            times.append(ts)
        points = np.concatenate(sweep_points, axis=0)
        times = np.concatenate(times, axis=0).astype(points.dtype)
        points = np.hstack([points, times])

        gt_boxes = np.asarray(info["gt_boxes"], np.float32).reshape(-1, 9)
        names = np.asarray(info["gt_names"])
        if len(gt_boxes) == 0:
            continue
        point_indices = box_np_ops.points_in_rbbox(points, gt_boxes)
        for i in range(len(gt_boxes)):
            name = str(names[i])
            if used_classes is not None and name not in used_classes:
                continue
            filename = f"{idx}_{name}_{i}.bin"
            gt_points = points[point_indices[:, i]]
            gt_points = gt_points.copy()
            gt_points[:, :3] -= gt_boxes[i, :3]
            with open(os.path.join(db_path, filename), "w") as f:
                gt_points.astype(np.float32).tofile(f)
            db_info = {
                "name": name,
                "path": os.path.join(tag, filename),
                "image_idx": idx,
                "gt_idx": i,
                "box3d_lidar": gt_boxes[i],
                "num_points_in_gt": int(gt_points.shape[0]),
                "difficulty": 0,
                "group_id": group_counter,
            }
            group_counter += 1
            all_db_infos.setdefault(name, []).append(db_info)

    with open(dbinfo_path, "wb") as f:
        pickle.dump(all_db_infos, f)
    return dbinfo_path
