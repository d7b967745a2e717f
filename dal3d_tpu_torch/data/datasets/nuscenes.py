"""nuScenes dataset (infos-pkl driven) with CBGS class-balanced resampling
(port of ``dal3d_tpu/data/datasets/nuscenes.py``).

In test mode the infos are taken as they are; in train mode ``_set_infos``
resamples the frames per class with ratio (1 / num_classes) / class frequency
(CBGS), drawing from numpy's global generator as the JAX package does.
``get_sensor_data`` runs the pipeline over the info dict. ``evaluation``
is not ported yet.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional

import numpy as np

from ..pipelines.loading import LoadPointCloudAnnotations, LoadPointCloudFromFile
from ..pipelines.preprocess import Preprocess, ReformatFixedShape


def build_pipeline(pipeline_cfgs: List[dict], tasks=None, max_points=300000,
                   voxelize_host=None):
    stages = []
    for cfg in pipeline_cfgs:
        cfg = dict(cfg)
        t = cfg.pop("type")
        if t == "LoadPointCloudFromFile":
            stages.append(LoadPointCloudFromFile(**cfg))
        elif t == "LoadPointCloudAnnotations":
            stages.append(LoadPointCloudAnnotations(**cfg))
        elif t == "Preprocess":
            stages.append(Preprocess(cfg["cfg"]))
        elif t in ("Reformat", "ReformatFixedShape"):
            cfg.setdefault("voxelize_host", voxelize_host)
            stages.append(ReformatFixedShape(tasks=tasks, max_points=max_points, **cfg))
        elif t in ("Voxelization", "AssignTarget"):
            # not host stages here: voxels come from ReformatFixedShape,
            # targets are assigned on the device
            continue
        else:
            raise KeyError(f"unknown pipeline stage {t}")
    # val-mode sweep-read cap: when every stage between the lidar load and the
    # fixed-shape reformat preserves point order (no shuffle/subsample), the
    # reformat keeps the first max_points rows — so reading past the cap is
    # wasted IO. Only the stage set below is provably order-preserving in val
    # mode; anything else disables the cap.
    _order_preserving = (LoadPointCloudFromFile, LoadPointCloudAnnotations,
                         ReformatFixedShape)
    safe = all(
        isinstance(s, _order_preserving)
        or (isinstance(s, Preprocess) and not s.shuffle_points)
        for s in stages
    )
    if safe:
        for s in stages:
            if isinstance(s, LoadPointCloudFromFile):
                s.max_points = max_points
    return stages


class NuScenesDataset:
    NumPointFeatures = 5

    def __init__(
        self,
        info_path: str,
        root_path: str = "",
        nsweeps: int = 10,
        class_names: Optional[List[str]] = None,
        pipeline: Optional[List[dict]] = None,
        tasks: Optional[List[dict]] = None,
        test_mode: bool = False,
        max_points: int = 300000,
        version: str = "v1.0-trainval",
        voxelize_host=None,
        **kwargs,
    ):
        self._info_path = info_path
        self._root_path = root_path
        self.nsweeps = nsweeps
        if self.nsweeps <= 0:
            raise ValueError("nsweeps must be at least 1")
        self._class_names = list(class_names or [])
        self.test_mode = test_mode
        self.version = version
        self.load_infos(info_path)
        self.pipeline = (
            build_pipeline(pipeline or [], tasks=tasks, max_points=max_points,
                           voxelize_host=voxelize_host)
            if pipeline else []
        )

    def load_infos(self, info_path: str):
        """Load infos; in train mode apply CBGS class-balanced resampling:
        every frame is listed once per distinct class it contains, and each
        class's frame list is resampled so that all classes contribute an
        equal share (1 / num_classes) of the epoch."""
        with open(info_path, "rb") as f:
            all_infos = pickle.load(f)
        self._set_infos(all_infos)

    def _set_infos(self, all_infos):
        """Install ``all_infos`` as the epoch pool: flatten at test time,
        CBGS-resample at train time."""
        if self.test_mode:
            # eval infos may be stored as a dict of splits
            self._nusc_infos = (
                [i for v in all_infos.values() for i in v]
                if isinstance(all_infos, dict) else list(all_infos)
            )
            return
        per_class = {name: [] for name in self._class_names}
        for info in all_infos:
            for name in set(info["gt_names"]) & set(self._class_names):
                per_class[name].append(info)
        total = sum(len(v) for v in per_class.values())
        if total == 0:  # no labels at all (e.g. unlabeled pool): keep as-is
            self._nusc_infos = list(all_infos)
            return
        target_share = 1.0 / len(self._class_names)
        resampled = []
        for frames in per_class.values():
            share = len(frames) / total
            if share > 0:
                take = int(len(frames) * target_share / share)
                resampled += np.random.choice(frames, take).tolist()
        self._nusc_infos = resampled

    @property
    def infos(self) -> List[dict]:
        return self._nusc_infos

    @property
    def class_names(self) -> List[str]:
        return self._class_names

    def __len__(self):
        return len(self._nusc_infos)

    def get_sensor_data(self, idx: int, info: Optional[dict] = None) -> Dict[str, Any]:
        """Run the pipeline for frame ``idx``; ``info`` overrides the stored
        info dict."""
        if info is None:
            info = self._nusc_infos[idx]
        res = {
            "lidar": {"type": "lidar", "points": None, "nsweeps": self.nsweeps},
            "metadata": {
                "image_prefix": self._root_path,
                "num_point_features": self.NumPointFeatures,
                "token": info["token"],
            },
            "mode": "val" if self.test_mode else "train",
        }
        for stage in self.pipeline:
            res, info = stage(res, info)
        return res

    def __getitem__(self, idx: int):
        return self.get_sensor_data(idx)
