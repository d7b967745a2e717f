"""Train and predict steps (port of ``dal3d_tpu/runtime/steps.py``).

Predict: host voxels (or raw points) in; detections, the pooled neck
embedding and the per-frame score entropy out: the fixed-shape dict the
evaluation and the AL pool scoring consume. Train: host voxels (or raw
points) and padded per-task GT boxes in; one forward in train mode, on-device
target assignment, loss, backward, clip and AdamW update; five scalar logs
out.

Batch dict contract (leading dim B):
  voxel_features [B, N, F] f32 or bf16, voxel_coords [B, N, 3] int (z, y, x),
  voxel_valid [B, N] bool
  or, without voxel_features (a config with ``voxelize_host = False``):
  points [B, P, F] f32 (padded), points_valid [B, P] bool, voxelized on the
  device (``ops/voxelize.py``); with host voxels the points are not moved
  gt_boxes      list per task of [B, G, 9]            (train)
  gt_classes    list per task of [B, G] int32, task-local 1-based, 0 = pad
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..models.heads.mg_head import multi_group_loss, multi_group_predict
from ..parallel.mesh import all_reduce_gradients, reduce_logs


def _to_device(x, device, dtype=None):
    t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
    return t.to(device=device, dtype=dtype, non_blocking=True)


VOXEL_KEYS = ("voxel_features", "voxel_coords", "voxel_valid")
POINT_KEYS = ("points", "points_valid")


def predict_feed(batch: Dict) -> Dict:
    """What a loader's batch feeds the predict step: its host voxels, or its
    raw points when the loader ships no voxels (``voxelize_host = False``)."""
    return {k: batch[k] for k in (VOXEL_KEYS if "voxel_features" in batch else POINT_KEYS)}


def model_inputs(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The model's keyword inputs from a batch: its host voxels when it has
    them, else its raw points (as JAX's steps choose)."""
    if "voxel_features" in batch:
        return {"vf": _to_device(batch["voxel_features"], device),
                "vc": _to_device(batch["voxel_coords"], device, torch.int32),
                "vv": _to_device(batch["voxel_valid"], device, torch.bool)}
    return {"points": _to_device(batch["points"], device, torch.float32),
            "points_valid": _to_device(batch["points_valid"], device, torch.bool)}


def autotuned_convs():
    """cuDNN with its autotuner on and TF32 off, around the steps' forward
    and backward: without TF32, cuDNN's default choice for f32 3x3 convs at
    BEV-map sizes is an FFT algorithm, several times slower (325 of a 403 ms
    BEVFusion predict, 400 of a 483 ms f32 CBGS predict on an H100 in
    ``chip_smoke.py``); the autotuner times the candidates on the first call
    of each shape and keeps the fastest. Every forward of the models' 2D
    convs runs under it: PyTorch keys its cache of conv plans by shapes,
    dtype, layout and the deterministic and TF32 flags, not by the
    autotuner's flag, so a first call at a shape outside it would leave
    the heuristic's plan to every later call there."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=True, deterministic=False,
                                      allow_tf32=False)


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
    ``num_pos``, ``loc_loss`` and ``cls_loss`` (summed over the tasks).
    The forward and backward run under ``autotuned_convs``.

    In a world of several ranks (``parallel``) the batch is the rank's rows
    of the global batch: the norms take the global batch's statistics, the
    gradients are averaged over the ranks before the clip, and the logs are
    the global batch's (``num_pos`` summed). The loss needs no other change:
    it is normalised per frame and divided by the rows, so the mean over the
    ranks is the global batch's."""
    _full_f32()
    model, dev = bundle.model, bundle.device

    def train_step(batch: Dict) -> Dict[str, torch.Tensor]:
        if not model.training:
            model.train()
        inputs = model_inputs(batch, dev)
        gt_boxes = [_to_device(b, dev, torch.float32) for b in batch["gt_boxes"]]
        gt_classes = [_to_device(c, dev, torch.int32) for c in batch["gt_classes"]]
        optimizer.zero_grad()
        with autotuned_convs():
            out = model(**inputs)
            labels, targets, _ = bundle.assigner.assign_all(gt_boxes, gt_classes)
            logs = multi_group_loss(out["preds"], labels, targets, bundle.num_classes,
                                    bundle.loss_cfg)
            logs["loss"].backward()
        all_reduce_gradients(optimizer.params.values())
        grad_norm = optimizer.step()
        out = reduce_logs({
            "loss": logs["loss"].detach(),
            "num_pos": sum(logs["num_pos"]),
            "loc_loss": sum(x.detach() for x in logs["loc_loss"]),
            "cls_loss": sum(x.detach() for x in logs["cls_loss"]),
        }, sums=("num_pos",))
        return {**out, "grad_norm": grad_norm}

    return train_step


def make_predict_step(bundle) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """Detection forward of a ``models.builder.DetectorBundle``.

    The step takes a batch dict with ``voxel_features`` [B, N, F] (f32 or
    bf16), ``voxel_coords`` [B, N, 3] int (z, y, x) and ``voxel_valid``
    [B, N], or without them ``points`` [B, P, F] and ``points_valid`` [B, P]
    (numpy arrays or tensors, moved to the model's device) and returns
    box3d_lidar [B, D, 9], scores [B, D], label_preds [B, D], det_valid
    [B, D], embedding [B, 512] and score_entropy [B].

    f32 layers run in full f32: making a step turns TF32 off for cuDNN
    convolutions and matmuls (the JAX reference has no TF32), and the
    forward runs under ``autotuned_convs``. The step puts the model in eval
    mode (a trainer may hold both steps) and runs under
    ``torch.inference_mode``: its outputs must not be trained on."""
    _full_f32()
    model, dev = bundle.model, bundle.device

    @torch.inference_mode()
    def predict_step(batch: Dict) -> Dict[str, torch.Tensor]:
        if model.training:
            model.eval()
        with autotuned_convs():
            out = model(**model_inputs(batch, dev))
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
