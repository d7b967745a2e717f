"""Train and predict steps (port of ``dal3d_tpu/runtime/steps.py``).

Predict: host voxels in; detections, the pooled neck embedding and the
per-frame score entropy out: the fixed-shape dict the evaluation and the AL
pool scoring consume. Train: host voxels and padded per-task GT boxes in; one
forward in train mode, on-device target assignment, loss, backward, clip and
AdamW update; five scalar logs out.

Batch dict contract (leading dim B):
  voxel_features [B, N, F] f32 or bf16, voxel_coords [B, N, 3] int (z, y, x),
  voxel_valid [B, N] bool
  gt_boxes      list per task of [B, G, 9]            (train)
  gt_classes    list per task of [B, G] int32, task-local 1-based, 0 = pad
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..models.heads.mg_head import multi_group_loss, multi_group_predict


def _to_device(x, device, dtype=None):
    t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
    return t.to(device=device, dtype=dtype, non_blocking=True)


def _full_f32() -> None:
    """f32 layers run in full f32: no TF32 for cuDNN convolutions and matmuls
    (the JAX reference has none)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def make_train_step(bundle, optimizer) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """Train step of a ``models.builder.DetectorBundle`` and a
    ``solver.optim.OneCycleAdamW`` bound to its model's parameters.

    The step puts the model in train mode (batch-norm batch statistics, which
    also move the running ones), assigns targets on the device, takes the
    multi-group loss, back-propagates, and lets the optimizer clip and update.
    It returns 0-d tensors ``loss``, ``grad_norm`` (before the clip),
    ``num_pos``, ``loc_loss`` and ``cls_loss`` (summed over the tasks)."""
    _full_f32()
    model, dev = bundle.model, bundle.device

    def train_step(batch: Dict) -> Dict[str, torch.Tensor]:
        if not model.training:
            model.train()
        vf = _to_device(batch["voxel_features"], dev)
        vc = _to_device(batch["voxel_coords"], dev, torch.int32)
        vv = _to_device(batch["voxel_valid"], dev, torch.bool)
        gt_boxes = [_to_device(b, dev, torch.float32) for b in batch["gt_boxes"]]
        gt_classes = [_to_device(c, dev, torch.int32) for c in batch["gt_classes"]]
        optimizer.zero_grad()
        out = model(vf, vc, vv)
        labels, targets, _ = bundle.assigner.assign_all(gt_boxes, gt_classes)
        logs = multi_group_loss(out["preds"], labels, targets, bundle.num_classes,
                                bundle.loss_cfg)
        logs["loss"].backward()
        grad_norm = optimizer.step()
        return {
            "loss": logs["loss"].detach(),
            "grad_norm": grad_norm,
            "num_pos": sum(logs["num_pos"]),
            "loc_loss": sum(x.detach() for x in logs["loc_loss"]),
            "cls_loss": sum(x.detach() for x in logs["cls_loss"]),
        }

    return train_step


def make_predict_step(bundle) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """Detection forward of a ``models.builder.DetectorBundle``.

    The step takes a batch dict with ``voxel_features`` [B, N, F] (f32 or
    bf16), ``voxel_coords`` [B, N, 3] int (z, y, x) and ``voxel_valid``
    [B, N] (numpy arrays or tensors, moved to the model's device) and returns
    box3d_lidar [B, D, 9], scores [B, D], label_preds [B, D], det_valid
    [B, D], embedding [B, 512] and score_entropy [B].

    f32 layers run in full f32: making a step turns TF32 off for cuDNN
    convolutions and matmuls (the JAX reference has no TF32). The step puts
    the model in eval mode (a trainer may hold both steps) and runs under
    ``torch.inference_mode``: its outputs must not be trained on."""
    _full_f32()
    model, dev = bundle.model, bundle.device

    @torch.inference_mode()
    def predict_step(batch: Dict) -> Dict[str, torch.Tensor]:
        if model.training:
            model.eval()
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
