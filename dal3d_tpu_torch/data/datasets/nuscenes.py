"""nuScenes dataset (infos-pkl driven), test mode (port of
``dal3d_tpu/data/datasets/nuscenes.py``).

The pool-scoring and evaluation side: the infos are taken as they are, and
``get_sensor_data`` runs the pipeline over the info dict. Train mode (CBGS
class-balanced resampling, ``reset``) and ``evaluation`` belong to later
slices of the port.
"""
from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional

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
        if not test_mode:
            raise NotImplementedError("only test_mode=True is ported (train-mode CBGS "
                                      "resampling comes with the training slice)")
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
        with open(info_path, "rb") as f:
            all_infos = pickle.load(f)
        self._nusc_infos_all = all_infos
        # eval infos may be stored as a dict of splits
        self._nusc_infos = (
            [i for v in all_infos.values() for i in v]
            if isinstance(all_infos, dict) else list(all_infos)
        )

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
            "mode": "val",
        }
        for stage in self.pipeline:
            res, info = stage(res, info)
        return res

    def __getitem__(self, idx: int):
        return self.get_sensor_data(idx)
