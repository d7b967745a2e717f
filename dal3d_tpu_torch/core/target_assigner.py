"""On-device, batched anchor -> GT target assignment (port of
``dal3d_tpu/core/target_assigner.py``).

The whole assignment is fixed-shape tensor code that runs inside the train
step, over (batch, class) at once where JAX vmaps. GT boxes arrive as padded
[B, G_max, ndim] arrays; a GT counts for a class when its task-local class id
equals that class.

Semantics (as the JAX module, which holds them against a numpy port of the
reference):
- per-class assignment against that class's own anchor block,
- bidirectional argmax with force-matching of each GT's best anchors (ties
  included; zero-overlap GTs never force-match; ties in the anchor's argmax go
  to the first GT),
- thresholds: >= matched -> positive, < unmatched -> background (0),
  in-between -> ignore (-1); force-match overrides background,
- regression targets encoded for positives only; reg weight 1 for positives,
- empty GT set -> all labels 0.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from . import box_ops
from .anchors import TaskAnchors
from .box_coders import GroundBox3dCoder

_NEG = -1e8


def assign_one_class(anchors: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                     class_id: torch.Tensor, matched_threshold: torch.Tensor,
                     unmatched_threshold: torch.Tensor, vec_encode: bool = True):
    """anchors [..., A, ndim], gt_boxes [..., G, ndim] (padded), gt_valid
    [..., G] (valid AND of this class), class_id / thresholds [...] (leading
    dims broadcast against each other). Returns labels [..., A] int32, targets
    [..., A, code], reg_weights [..., A] f32."""
    nd = anchors.shape[-1]
    cols = [0, 1, 3, 4, nd - 1]
    S = box_ops.nearest_iou_similarity(anchors[..., cols], gt_boxes[..., cols])  # [..., A, G]
    S = torch.where(gt_valid[..., None, :], S, torch.full((), _NEG, dtype=S.dtype, device=S.device))

    a2g_max, a2g_argmax = S.max(dim=-1)  # ties -> first
    g2a_max = S.max(dim=-2).values
    # GTs with zero best overlap (or invalid) never force-match
    g2a_ok = g2a_max > 0
    force = ((S == g2a_max[..., None, :]) & g2a_ok[..., None, :]).any(dim=-1)

    pos = a2g_max >= matched_threshold[..., None]
    bg = a2g_max < unmatched_threshold[..., None]

    cid = class_id.to(torch.int32)[..., None].expand(pos.shape)
    labels = torch.full(pos.shape, -1, dtype=torch.int32, device=S.device)
    labels = torch.where(bg, torch.zeros_like(labels), labels)
    labels = torch.where(pos | force, cid, labels)
    labels = torch.where(gt_valid.any(dim=-1)[..., None], labels, torch.zeros_like(labels))

    gt_b = gt_boxes.expand(*S.shape[:-2], *gt_boxes.shape[-2:])
    matched_gt = torch.nan_to_num(torch.gather(
        gt_b, -2, a2g_argmax[..., None].expand(*a2g_argmax.shape, nd)))
    targets = box_ops.second_box_encode(matched_gt, anchors, encode_angle_to_vector=vec_encode)
    fg = labels > 0
    targets = torch.where(fg[..., None], targets, torch.zeros((), dtype=targets.dtype,
                                                              device=targets.device))
    return labels, targets, fg.to(torch.float32)


@dataclass
class DeviceTargetAssigner:
    """Batched multi-task assignment bound to static anchor bundles."""

    task_anchors: List[TaskAnchors]
    box_coder: GroundBox3dCoder
    _consts: dict = field(default_factory=dict, repr=False)

    def _task_consts(self, task_idx: int, device):
        key = (task_idx, str(device))
        if key not in self._consts:
            ta = self.task_anchors[task_idx]
            self._consts[key] = (
                torch.as_tensor(ta.anchors_by_class, device=device),  # [C, A_c, ndim]
                torch.arange(1, ta.num_classes + 1, device=device),
                torch.as_tensor(ta.matched_thresholds, device=device),
                torch.as_tensor(ta.unmatched_thresholds, device=device),
            )
        return self._consts[key]

    def assign_task(self, task_idx: int, gt_boxes: torch.Tensor, gt_classes: torch.Tensor):
        """Assignment of one task: gt_boxes [B, G, ndim] padded, gt_classes
        [B, G] task-local 1-based (0 = padding / not in task). Returns
        labels [B, L*C*R], targets [B, L*C*R, code], reg_weights [B, L*C*R]
        in the head's (location, class, rotation) anchor order."""
        ta = self.task_anchors[task_idx]
        C, R = ta.num_classes, ta.num_rot
        anchors, class_ids, mt, ut = self._task_consts(task_idx, gt_boxes.device)
        B = gt_boxes.shape[0]
        gt_valid = gt_classes[:, None, :] == class_ids[None, :, None]  # [B, C, G]
        labels, targets, rw = assign_one_class(
            anchors[None], gt_boxes[:, None], gt_valid, class_ids[None], mt[None], ut[None],
            vec_encode=self.box_coder.vec_encode)
        # interleave [B, C, L*R(, code)] -> (L, C, R(, code)) flat
        L = int(np.prod(ta.feature_map_size))
        code = targets.shape[-1]
        labels = labels.reshape(B, C, L, R).permute(0, 2, 1, 3).reshape(B, -1)
        targets = targets.reshape(B, C, L, R, code).permute(0, 2, 1, 3, 4).reshape(B, -1, code)
        rw = rw.reshape(B, C, L, R).permute(0, 2, 1, 3).reshape(B, -1)
        return labels, targets, rw

    @torch.no_grad()
    def assign_all(self, gt_boxes_by_task, gt_classes_by_task):
        """Assignment across tasks: lists per task of [B, G, ndim] and [B, G]
        -> lists per task of labels [B, A], reg_targets [B, A, code],
        reg_weights [B, A]."""
        out_labels, out_targets, out_rw = [], [], []
        for t in range(len(self.task_anchors)):
            lab, tg, w = self.assign_task(t, gt_boxes_by_task[t], gt_classes_by_task[t])
            out_labels.append(lab)
            out_targets.append(tg)
            out_rw.append(w)
        return out_labels, out_targets, out_rw
