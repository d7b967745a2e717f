"""Point-cloud + annotation loading stages (port of
``dal3d_tpu/data/pipelines/loading.py``; numpy only).

Parity with det3d/datasets/pipelines/loading.py:66-125 (NuScenesDataset path):
read the keyframe lidar bin [N, 5] (x,y,z,intensity,ring->dropped to 4 used
dims +? — nuScenes bins are [N,5], the reference keeps 4 columns + time), then
concatenate nsweeps-1 randomly chosen prior sweeps transformed into the
keyframe, with per-point time lag as the 5th feature.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def read_file(path: str, num_features: int = 4,
              max_rows: Optional[int] = None) -> np.ndarray:
    """nuScenes lidar .bin -> [N, num_features] (x, y, z, intensity).

    ``max_rows`` reads only the first rows from disk (np.fromfile count) —
    used by the val-mode sweep cap to skip IO for points a later fixed-shape
    truncation would discard anyway."""
    count = -1 if max_rows is None else max_rows * 5
    return np.fromfile(path, dtype=np.float32, count=count).reshape(-1, 5)[:, :num_features]


def read_sweep(sweep: dict, max_rows: Optional[int] = None) -> tuple:
    points_sweep = read_file(str(sweep["lidar_path"]), max_rows=max_rows).T  # [4, N]
    nbr_points = points_sweep.shape[1]
    if sweep["transform_matrix"] is not None:
        tm = np.asarray(sweep["transform_matrix"])
        points_sweep[:3, :] = tm.dot(
            np.vstack((points_sweep[:3, :], np.ones(nbr_points)))
        )[:3, :]
    curr_times = sweep["time_lag"] * np.ones((1, nbr_points))
    return points_sweep.T, curr_times.T


class LoadPointCloudFromFile:
    def __init__(self, dataset: str = "NuScenesDataset", **kwargs):
        self.type = dataset
        # val-mode point cap, wired by build_pipeline ONLY when every later
        # stage preserves point order up to the fixed-shape truncation (no
        # shuffles/subsamples): reading past the cap is then pure waste —
        # ReformatFixedShape keeps the first max_points rows either way.
        # Bit-identical to the uncapped read by construction; a host-IO
        # cut at nsweeps=10 (the sweep concat otherwise reads and transforms
        # every sweep to keep max_points rows).
        self.max_points: Optional[int] = None

    def __call__(self, res: dict, info: dict):
        res["type"] = self.type
        nsweeps = res["lidar"]["nsweeps"]
        cap = self.max_points if res.get("mode") == "val" else None
        points = read_file(str(info["lidar_path"]), max_rows=cap)
        total = points.shape[0]
        sweep_points_list = [points]
        sweep_times_list = [np.zeros((points.shape[0], 1))]
        if nsweeps > 1:
            if nsweeps - 1 > len(info["sweeps"]):
                raise ValueError(f"nsweeps {nsweeps} > sweep list {len(info['sweeps'])}")
            # the sweep choice is drawn identically whether or not the cap
            # stops the read loop early (same RNG stream, same sweeps)
            for i in np.random.choice(len(info["sweeps"]), nsweeps - 1, replace=False):
                if cap is not None and total >= cap:
                    break
                points_sweep, times_sweep = read_sweep(
                    info["sweeps"][i],
                    max_rows=None if cap is None else cap - total)
                total += points_sweep.shape[0]
                sweep_points_list.append(points_sweep)
                sweep_times_list.append(times_sweep)
        points = np.concatenate(sweep_points_list, axis=0)
        times = np.concatenate(sweep_times_list, axis=0).astype(points.dtype)
        res["lidar"]["points"] = points
        res["lidar"]["times"] = times
        res["lidar"]["combined"] = np.hstack([points, times])
        return res, info


class LoadPointCloudAnnotations:
    def __init__(self, with_bbox: bool = True, **kwargs):
        pass

    def __call__(self, res: dict, info: dict):
        if "gt_boxes" in info:
            res["lidar"]["annotations"] = {
                "boxes": np.asarray(info["gt_boxes"], np.float32),
                "names": np.asarray(info["gt_names"]),
                "tokens": np.asarray(info.get("gt_boxes_token", [""] * len(info["gt_names"]))),
                "velocities": np.asarray(
                    info.get("gt_boxes_velocity", np.zeros((len(info["gt_names"]), 3))),
                    np.float32,
                ),
            }
        return res, info
