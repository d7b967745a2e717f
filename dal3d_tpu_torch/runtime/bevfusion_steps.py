"""BEVFusion predict step (port of the predict half of
``dal3d_tpu/runtime/bevfusion_steps.py``; the train step waits for
BEVFusion training, ROADMAP A10).

Batch contract (leading dim B): host voxels ``voxel_features`` [B, N, F],
``voxel_coords`` [B, N, 3] int (z, y, x), ``voxel_valid`` [B, N] (numpy
arrays or tensors), as the dataset's ``ReformatFixedShape`` with
``voxelize_host`` makes them; or, without them, raw ``points`` [B, P, F] and
``points_valid`` [B, P], voxelized on the device at the config's grid
(``ops/voxelize.py::voxelize_mean_grid``). Camera keys are ignored by the
lidar-only model.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..models.bevfusion.transfusion import transfusion_decode
from .steps import _full_f32, model_inputs

CAMERA_KEYS = (
    "images", "depth_images", "camera2lidar_rots", "camera2lidar_trans",
    "camera_intrinsics", "img_aug_rots", "img_aug_trans",
)


def autotuned_convs():
    """cuDNN with its autotuner on and TF32 off, for the BEVFusion forward
    (see ``make_bevfusion_predict_step``)."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=True, deterministic=False,
                                      allow_tf32=False)


def make_bevfusion_predict_step(bundle) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """Detection forward of a ``models.builder.BEVFusionBundle``: the batch
    dict above in; ``transfusion_decode``'s dict out (box3d_lidar [B, P, 9],
    scores [B, P], label_preds [B, P], det_valid [B, P]) with ``bev_feat``,
    the neck's BEV map [B, H, W, 512], beside it.

    f32 throughout: making a step turns TF32 off for cuDNN convolutions and
    matmuls (the JAX reference has none). The step puts the model in eval
    mode and runs under ``torch.inference_mode``, with cuDNN's autotuner on
    for its forward: without TF32, cuDNN's default choice for SECOND's f32
    3x3 convs at 180 x 180 is an FFT algorithm that took 325 ms of a 403 ms
    predict on an H100 (``chip_smoke.py`` phase 14); the autotuner times the
    candidates on the first call of each shape and keeps the fastest."""
    _full_f32()
    model, dev = bundle.model, bundle.device

    @torch.inference_mode()
    def predict_step(batch: Dict) -> Dict[str, torch.Tensor]:
        if model.training:
            model.eval()
        inputs = model_inputs(batch, dev)
        with autotuned_convs():
            if "vf" in inputs:
                preds = model(inputs["vf"].float(), inputs["vc"], inputs["vv"])
            else:
                preds = model(**inputs)
        out = transfusion_decode(preds, bundle.test_cfg)
        out["bev_feat"] = preds["bev_feat"]
        return out

    return predict_step
