"""IoU / frame-loss variants of the multi-group CBGS head (port of
``dal3d_tpu/models/heads/mg_loss_head.py``).

- ``MultiGroupIoUHead``: each task adds a per-anchor IoU-quality branch,
  1x1 conv (``iou_hidden``) -> batch norm -> ReLU -> 1x1 conv (anchors per
  location), trained by ``multi_group_loss_with_iou`` against the 3D IoU of
  each decoded anchor box with its best valid GT box (smooth-L1 on
  normalised targets, or sigmoid cross-entropy on raw ones) and decoded at
  predict time by ``decode_iou_preds``.
- ``MultiGroupLossHead``: each task adds a frame-level loss estimate, a
  global average pool, then 1x1 conv (C/2) -> batch norm -> ReLU -> 1x1 conv
  (``num_loss``), supervised by ``compute_loss_loss``.

NHWC in, NHWC out, as ``heads/mg_head.py::MultiGroupHead``; the 1x1 convs
are matmuls over the channel dim, the batch norms flax's (eps 1e-3,
momentum 0.99, over every axis but the channels).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.box_coders import GroundBox3dCoder
from ...ops.rotated_iou_fast import boxes_iou3d_fast
from ..layers import BatchNormLast
from ..losses.losses import prepare_loss_weights, weighted_smooth_l1
from .mg_head import LossConfig, MultiGroupHead, multi_group_loss


def _conv1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, conv.weight.flatten(1), conv.bias)


class _Branch(nn.Module):
    """1x1 conv -> batch norm -> ReLU -> 1x1 conv over NHWC maps."""

    def __init__(self, cin: int, hidden: int, cout: int):
        super().__init__()
        self.mlp0 = nn.Conv2d(cin, hidden, 1)
        self.bn = BatchNormLast(hidden, eps=1e-3, momentum=0.01)
        self.mlp1 = nn.Conv2d(hidden, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv1x1(self.mlp1, torch.relu(self.bn(_conv1x1(self.mlp0, x))))


class MultiGroupIoUHead(nn.Module):
    """``MultiGroupHead`` + a per-anchor IoU branch per task
    (``preds[t]["iou_preds"]`` [B, H, W, anchors])."""

    def __init__(self, num_classes: Sequence[int], in_channels: int = 512,
                 code_size: int = 10, num_rot: int = 2, iou_hidden: int = 512):
        super().__init__()
        self.head = MultiGroupHead(num_classes, in_channels, code_size, num_rot)
        self.iou = nn.ModuleList(_Branch(in_channels, iou_hidden, nc * num_rot)
                                 for nc in num_classes)

    def forward(self, x: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        preds = self.head(x)
        for t, branch in enumerate(self.iou):
            preds[t]["iou_preds"] = branch(x)
        return preds


class MultiGroupLossHead(nn.Module):
    """``MultiGroupHead`` + a frame-level loss estimate per task
    (``preds[t]["loss_preds"]`` [B, num_loss])."""

    def __init__(self, num_classes: Sequence[int], in_channels: int = 512,
                 code_size: int = 10, num_rot: int = 2, num_loss: int = 1):
        super().__init__()
        self.head = MultiGroupHead(num_classes, in_channels, code_size, num_rot)
        self.loss = nn.ModuleList(_Branch(in_channels, in_channels // 2, num_loss)
                                  for _ in num_classes)

    def forward(self, x: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        preds = self.head(x)
        pooled = x.mean(dim=(1, 2), keepdim=True)  # [B, 1, 1, C]
        for t, branch in enumerate(self.loss):
            h = branch(pooled)
            preds[t]["loss_preds"] = h.reshape(h.shape[0], -1)
        return preds


def compute_loss_loss(loss_gt, loss_preds_by_task, batch_size: int):
    """|loss_gt - sum over the tasks of loss_preds.sum()| / B."""
    total_pred = sum(p.sum() for p in loss_preds_by_task)
    return torch.abs(loss_gt - total_pred) / batch_size


def multi_group_loss_with_iou(
    preds: List[Dict[str, torch.Tensor]],
    labels: List[torch.Tensor],
    reg_targets: List[torch.Tensor],
    task_anchors,
    box_coder: GroundBox3dCoder,
    gt_boxes_by_task: List[torch.Tensor],  # per task [B, G, 9]
    num_classes: Sequence[int],
    cfg: LossConfig = LossConfig(),
    iou_loss_weight: float = 1.0,
    iou_norm: Dict[str, float] | None = None,
    iou_loss_type: str = "smooth_l1",
    gt_classes_by_task: List[torch.Tensor] | None = None,  # [B, G], 0 = pad
):
    """``multi_group_loss`` + a per-task IoU loss: the target of an anchor is
    the 3D IoU of its decoded box with its best valid GT box (no gradient);
    padded GT rows never define a target.

    iou_loss_type:
    - "smooth_l1": targets normalised (iou - mean) / std (default mean 0.5,
      std 0.5), reg-weighted;
    - "sigmoid": sigmoid cross-entropy on raw [0, 1] targets, cls-weighted.
    """
    if iou_norm is None:
        iou_norm = {"mean": 0.5, "std": 0.5}
    logs = multi_group_loss(preds, labels, reg_targets, num_classes, cfg)
    iou_total = 0.0
    for t, pred in enumerate(preds):
        B = pred["box_preds"].shape[0]
        code = box_coder.code_size
        box_preds = pred["box_preds"].reshape(B, -1, code)
        anchors = torch.as_tensor(task_anchors[t].anchors, device=box_preds.device)
        iou_preds = pred["iou_preds"].reshape(B, -1)
        gts = gt_boxes_by_task[t]
        if gt_classes_by_task is not None:
            gvalid = gt_classes_by_task[t] > 0
        else:  # geometric validity of the pad convention
            gvalid = (gts[..., 3:6] > 0).any(-1) & (torch.abs(gts[..., :3]) > 1e-6).any(-1)
        with torch.no_grad():
            decoded = box_coder.decode(box_preds, anchors[None].expand(B, -1, -1))
            target_iou = torch.stack([
                torch.where(gvalid[b][None, :], boxes_iou3d_fast(decoded[b], gts[b]),
                            torch.zeros((), device=gts.device)).max(dim=1).values
                for b in range(B)])
        cls_weights, reg_weights, _ = prepare_loss_weights(
            labels[t], cfg.pos_cls_weight, cfg.neg_cls_weight, cfg.loss_norm_type)
        if iou_loss_type == "smooth_l1":
            tgt = (target_iou - iou_norm["mean"]) / iou_norm["std"]
            iou_loss = weighted_smooth_l1(iou_preds[..., None], tgt[..., None],
                                          reg_weights).sum() / B
        elif iou_loss_type == "sigmoid":
            p = iou_preds
            ce = torch.clamp(p, min=0) - p * target_iou + torch.log1p(torch.exp(-torch.abs(p)))
            iou_loss = (ce * cls_weights).sum() / B
        else:
            raise ValueError(f"unknown iou_loss_type {iou_loss_type!r}")
        iou_total = iou_total + iou_loss
    logs["iou_loss"] = iou_total
    logs["loss"] = logs["loss"] + iou_loss_weight * iou_total
    return logs


def decode_iou_preds(iou_preds: torch.Tensor, iou_loss_type: str = "smooth_l1",
                     iou_norm: Dict[str, float] | None = None) -> torch.Tensor:
    """Predict-time IoU decode: the smooth-L1 flavour de-normalises and
    clamps to [0, 1], the sigmoid flavour applies a sigmoid."""
    if iou_loss_type == "smooth_l1":
        if iou_norm is None:
            iou_norm = {"mean": 0.5, "std": 0.5}
        return torch.clamp(iou_preds * iou_norm["std"] + iou_norm["mean"], 0.0, 1.0)
    return torch.sigmoid(iou_preds)
