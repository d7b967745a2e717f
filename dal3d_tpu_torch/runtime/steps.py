"""Predict step (port of ``dal3d_tpu/runtime/steps.py::make_predict_step``).

Host voxels in; detections, the pooled neck embedding and the per-frame
score entropy out: the fixed-shape dict the evaluation and the AL pool
scoring consume.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..models.heads.mg_head import multi_group_predict


def _to_device(x, device, dtype=None):
    t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
    return t.to(device=device, dtype=dtype, non_blocking=True)


def make_predict_step(bundle) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """Detection forward of a ``models.builder.DetectorBundle``.

    The step takes a batch dict with ``voxel_features`` [B, N, F] (f32 or
    bf16), ``voxel_coords`` [B, N, 3] int (z, y, x) and ``voxel_valid``
    [B, N] (numpy arrays or tensors, moved to the model's device) and returns
    box3d_lidar [B, D, 9], scores [B, D], label_preds [B, D], det_valid
    [B, D], embedding [B, 512] and score_entropy [B].

    f32 layers run in full f32: making a step turns TF32 off for cuDNN
    convolutions and matmuls (the JAX reference has no TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model, dev = bundle.model, bundle.device

    @torch.inference_mode()
    def predict_step(batch: Dict) -> Dict[str, torch.Tensor]:
        vf = _to_device(batch["voxel_features"], dev)
        vc = _to_device(batch["voxel_coords"], dev, torch.int32)
        vv = _to_device(batch["voxel_valid"], dev, torch.bool)
        out = model(vf, vc, vv)
        dets = multi_group_predict(out["preds"], bundle.task_anchors, bundle.box_coder,
                                   bundle.test_cfg)
        dets["embedding"] = out["embedding"]
        # per-frame mean binary entropy of the detection scores
        s = torch.clamp(dets["scores"], 1e-6, 1 - 1e-6)
        ent = -(s * torch.log(s) + (1 - s) * torch.log(1 - s))
        valid = dets["det_valid"].to(ent.dtype)
        dets["score_entropy"] = (ent * valid).sum(-1) / torch.clamp(valid.sum(-1), min=1)
        return dets

    return predict_step
