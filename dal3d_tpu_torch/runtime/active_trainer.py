"""Dual-model trainer of the partial-label AL pipeline (port of
``dal3d_tpu/runtime/active_trainer.py``: ``make_estimator_step``,
``ActiveTrainer``).

The detector and a box-quality ``Estimator`` train side by side with their
own optimizers. Each iteration runs the detector's train step, then the
estimator step on the same batch, in this order:

1. the detector predicts in eval mode without gradients on the batch's raw
   points (voxelized on the device even when the batch carries host voxels,
   as JAX's step calls the model on points) with its convolutions
   autotuned, as the predict step's are; batch-norm running statistics
   are not touched and the model's mode is restored;
2. the first ``num_boxes`` detection slots and their ``det_valid``;
3. targets: each box's best 3D IoU (``ops/rotated_iou_fast.py``) with the
   valid GT boxes of every task;
4. loss: the ``det_valid``-weighted mean squared error of the estimator's
   output, then one ``solver.optim.Adam`` step (``optax.adam``).
"""
from __future__ import annotations

from typing import Dict

import torch

from ..models.heads.mg_head import multi_group_predict
from ..ops.rotated_iou_fast import boxes_iou3d_fast
from ..parallel.dist import shared_normaliser
from ..parallel.mesh import all_reduce_gradients, reduce_logs
from .steps import _to_device, autotuned_convs
from .trainer import Trainer


@torch.no_grad()
def estimator_inputs(bundle, batch: Dict, num_boxes: int = 64) -> Dict[str, torch.Tensor]:
    """Steps 1-3: the detector's frozen predictions on the batch's raw points
    and their IoU targets. Returns points [B, P, F], points_valid [B, P],
    boxes [B, num_boxes, 9], det_valid [B, num_boxes] and target [B,
    num_boxes] on the model's device."""
    model, dev = bundle.model, bundle.device
    points = _to_device(batch["points"], dev, torch.float32)
    points_valid = _to_device(batch["points_valid"], dev, torch.bool)
    was_training = model.training
    model.eval()
    try:
        # autotuned as in the predict step: PyTorch caches a conv's plan by its
        # shapes, not by how it was chosen, so cuDNN's heuristic choice here (an
        # FFT route for f32 at BEV-map sizes) would also serve every later
        # autotuned call at these shapes
        with autotuned_convs():
            out = model(points=points, points_valid=points_valid)
        preds = multi_group_predict(out["preds"], bundle.task_anchors, bundle.box_coder,
                                    bundle.test_cfg)
    finally:
        model.train(was_training)
    boxes = preds["box3d_lidar"][:, :num_boxes]
    det_valid = preds["det_valid"][:, :num_boxes]
    gt_all = torch.cat([_to_device(b, dev, torch.float32) for b in batch["gt_boxes"]], dim=1)
    gt_valid = torch.cat([_to_device(c, dev, torch.int32) > 0 for c in batch["gt_classes"]],
                         dim=1)
    zero = torch.zeros((), device=dev)
    target = torch.stack([
        torch.where(gt_valid[b][None, :], boxes_iou3d_fast(boxes[b], gt_all[b]), zero)
        .max(dim=1).values for b in range(boxes.shape[0])])
    return {"points": points, "points_valid": points_valid, "boxes": boxes,
            "det_valid": det_valid, "target": target}


def estimator_loss(estimator, points, points_valid, boxes, det_valid, target) -> torch.Tensor:
    """Step 4's loss: sum(w (pred - target)^2) / max(sum(w), 1), w =
    det_valid and the box finite.

    A slot with w = 0 goes into the estimator as an all-zero box with
    target 0, so that it adds exactly 0 to the loss and its gradient. A
    detector far from converged decodes boxes whose sizes overflow ``exp``
    in the slots without a detection; JAX's step weights their NaN
    predictions and targets by 0, and NaN * 0 turned the loss, the gradient
    and, through Adam, every weight of the estimator NaN for good. Where
    every box is finite the loss and its gradient are JAX's. In a world of
    several ranks the weight sum is the global batch's
    (``parallel.dist.shared_normaliser``)."""
    use = det_valid & torch.isfinite(boxes).all(-1)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    pred_iou = estimator(points, points_valid, torch.where(use[..., None], boxes, zero))
    w = use.to(pred_iou.dtype)
    return ((torch.square(pred_iou - torch.where(use, target, zero)) * w).sum()
            / shared_normaliser(w.sum(), 1.0))


def make_estimator_step(bundle, estimator, optimizer, num_boxes: int = 64):
    """The estimator step of a ``models.builder.DetectorBundle``, an
    ``Estimator`` on the same device and a ``solver.optim.Adam`` bound to
    its parameters: batch -> {"estimator_loss": 0-d tensor}. In a world of
    several ranks a rank predicts and trains on its rows, the gradients are
    averaged over the ranks before the update and the loss is the global
    batch's."""

    def step(batch: Dict) -> Dict[str, torch.Tensor]:
        inputs = estimator_inputs(bundle, batch, num_boxes)
        optimizer.zero_grad()
        loss = estimator_loss(estimator, **inputs)
        loss.backward()
        all_reduce_gradients(optimizer.params.values())
        optimizer.step()
        return reduce_logs({"estimator_loss": loss.detach()})

    return step


class ActiveTrainer(Trainer):
    """``Trainer`` + estimator co-training: each iteration's train step is
    followed by the estimator step on the same batch."""

    def __init__(self, bundle, optimizer, estimator, estimator_optimizer, work_dir: str, **kw):
        super().__init__(bundle, optimizer, work_dir, **kw)
        self.estimator = estimator
        self.estimator_optimizer = estimator_optimizer
        self.estimator_step = make_estimator_step(bundle, estimator, estimator_optimizer)
        self.estimator_initialized = False

    def init_estimator(self) -> None:
        """Bind the estimator's optimizer (fresh moments, count 0)."""
        self.estimator_optimizer.init(self.estimator.named_parameters())
        self.estimator_initialized = True

    def after_train_step(self, batch: Dict, logs: Dict[str, float]) -> Dict[str, float]:
        est_logs = self.estimator_step(batch)
        return {**logs, "estimator_loss": float(est_logs["estimator_loss"])}

    def train_epoch(self, loader):
        if not self.estimator_initialized:
            raise RuntimeError("call init_estimator first")
        stats = super().train_epoch(loader)
        if stats:
            self.logger.info(f"[active] epoch {self.epoch}: loss {stats['loss']:.4f}, "
                             f"estimator_loss {stats['estimator_loss']:.4f}")
        return stats
