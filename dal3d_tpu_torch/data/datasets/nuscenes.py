"""nuScenes dataset (infos-pkl driven) with CBGS class-balanced resampling
(port of ``dal3d_tpu/data/datasets/nuscenes.py``).

In test mode the infos are taken as they are; in train mode ``_set_infos``
resamples the frames per class with ratio (1 / num_classes) / class frequency
(CBGS), drawing from numpy's global generator as the JAX package does.
``get_sensor_data`` runs the pipeline over the info dict. ``evaluation``
writes the nuScenes submission json of padded detections and runs the
official devkit when it is installed.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Optional

import numpy as np

from ...utils.fileio import dump
from ..pipelines import camera, transforms_extra
from ..pipelines.bev_seg import LoadBEVSegmentation
from ..pipelines.loading import LoadPointCloudAnnotations, LoadPointCloudFromFile
from ..pipelines.preprocess import Preprocess, ReformatFixedShape

# the stages of transforms_extra under their config names (the reference's
# PhotoMetricDistortionMultiViewImage is ImageDistort)
EXTRA_STAGES = {name: name for name in (
    "FrameDropout", "PointSample", "BackgroundPointsFilter", "VoxelBasedPointSampler",
    "ImagePad", "ImageDistort", "GlobalRotScaleTrans", "RandomFlip3D", "ObjectPaste",
    "ObjectNoise", "PointShuffle", "ObjectRangeFilter", "PointsRangeFilter",
    "ObjectNameFilter")}
EXTRA_STAGES["PhotoMetricDistortionMultiViewImage"] = "ImageDistort"


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
        elif t in ("LoadMultiViewImages", "LoadMultiViewImageFromFiles"):
            stages.append(camera.LoadMultiViewImages(**cfg))
        elif t == "ImageAug3D":
            cfg.pop("is_train", None)  # train / val picked from res["mode"]
            stages.append(camera.ImageAug3D(**cfg))
        elif t == "GridMask":
            stages.append(camera.GridMask(**{k: v for k, v in cfg.items() if k in (
                "prob", "ratio", "rotate", "use_h", "use_w", "mode")}))
        elif t == "ImageNormalize":
            stages.append(camera.ImageNormalize(**cfg))
        elif t == "ReformatCamera":
            stages.append(camera.ReformatCamera(**cfg))
        elif t == "LoadBEVSegmentation":
            stages.append(LoadBEVSegmentation(**cfg))
        elif t in EXTRA_STAGES:
            cfg.pop("is_train", None)  # train / val picked from res["mode"]
            stages.append(getattr(transforms_extra, EXTRA_STAGES[t])(**cfg))
        else:
            raise KeyError(f"unknown pipeline stage {t}")
    # val-mode sweep-read cap: when every stage between the lidar load and the
    # fixed-shape reformat preserves point order (no shuffle/subsample), the
    # reformat keeps the first max_points rows — so reading past the cap is
    # wasted IO. Only the stage set below is provably order-preserving in val
    # mode (the camera stages and the map targets leave the points alone); anything else disables
    # the cap.
    _order_preserving = (LoadPointCloudFromFile, LoadPointCloudAnnotations,
                         ReformatFixedShape, camera.LoadMultiViewImages, camera.ImageAug3D,
                         camera.GridMask, camera.ImageNormalize, transforms_extra.ImagePad,
                         camera.ReformatCamera, LoadBEVSegmentation)
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
        self.eval_version = "detection_cvpr_2019"
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

    def convert_detections_to_nusc(self, detections: Dict[str, dict]) -> dict:
        """Padded detections (token -> box3d_lidar / scores / label_preds /
        det_valid, host arrays) -> nuScenes submission dict."""
        from .nusc_eval import detections_to_nusc_boxes

        nusc_annos = {"results": {}, "meta": {
            "use_camera": False, "use_lidar": True, "use_radar": False,
            "use_map": False, "use_external": False,
        }}
        token_to_info = {i["token"]: i for i in self._nusc_infos}
        for token, det in detections.items():
            info = token_to_info[token]
            nusc_annos["results"][token] = detections_to_nusc_boxes(
                det, info, self._class_names
            )
        return nusc_annos

    def evaluation(self, detections: Dict[str, dict], output_dir: str = ".", testset=False,
                   device=None):
        """Write ``<output_dir>/results_nusc.json``; run the official devkit
        when it is importable, else report the file alone (as the JAX
        package does). ``device`` is the IoUs' device of the datasets that
        compute IoUs (KITTI, Lyft); the devkit runs on the host."""
        nusc_annos = self.convert_detections_to_nusc(detections)
        res_path = os.path.join(output_dir, "results_nusc.json")
        dump(nusc_annos, res_path)
        try:
            from .nusc_eval import eval_main

            return eval_main(res_path, self._root_path, self.version, self.eval_version, output_dir)
        except ImportError:
            return {"results": {"nusc": f"submission written to {res_path} (devkit unavailable)"}}
