"""Lyft Level-5 dataset (port of ``dal3d_tpu/data/datasets/lyft.py``; the
reference's det3d/datasets/lyft/lyft.py).

Lyft shares the nuScenes info schema, so the dataset is the nuScenes loader
with the Lyft class set. ``evaluation`` always writes the submission json
(``results_lyft.json``) and, when every info carries its GT, adds the kaggle
Lyft score of ``eval/lyft_eval.py`` with the IoUs on ``device`` (``None``:
the CUDA card).
"""
from __future__ import annotations

import os

import numpy as np

from ...utils.fileio import dump
from .nuscenes import NuScenesDataset

LYFT_CLASSES = (
    "car", "truck", "bus", "emergency_vehicle", "other_vehicle",
    "motorcycle", "bicycle", "pedestrian", "animal",
)


class LyftDataset(NuScenesDataset):
    NumPointFeatures = 5

    def __init__(self, *args, class_names=None, **kwargs):
        super().__init__(*args, class_names=list(class_names or LYFT_CLASSES), **kwargs)

    def evaluation(self, detections, output_dir=".", device=None, **kwargs):
        from ...eval.lyft_eval import lyft_eval

        res_path = os.path.join(output_dir, "results_lyft.json")
        dump(self.convert_detections_to_nusc(detections), res_path)
        results = {"lyft": f"submission written to {res_path}"}
        if all("gt_boxes" in info for info in self._nusc_infos):
            gt_frames, pred_frames = [], []
            for info in self._nusc_infos:
                det = detections.get(info["token"])
                if det is None:
                    continue
                gt_frames.append({"boxes": np.asarray(info["gt_boxes"]),
                                  "names": np.asarray(info["gt_names"])})
                valid = np.asarray(det.get("det_valid", np.ones(len(det["scores"]), bool)))
                labels = np.asarray(det["label_preds"])[valid]
                pred_frames.append({
                    "boxes": np.asarray(det["box3d_lidar"])[valid],
                    "names": np.asarray([self._class_names[i] for i in labels]),
                    "scores": np.asarray(det["scores"])[valid],
                })
            if gt_frames:
                results.update(lyft_eval(gt_frames, pred_frames, self._class_names,
                                         device=device))
        return {"results": results}
