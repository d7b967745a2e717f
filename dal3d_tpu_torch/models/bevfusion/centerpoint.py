"""CenterPoint-style centre head, its decode and its loss (port of
``dal3d_tpu/models/bevfusion/centerpoint.py``): BEVFusion's alternative to
the TransFusion head.

A shared 3x3 conv + BN + ReLU, then per task group six branches (3x3 conv +
BN + ReLU, then a 3x3 conv with bias): the class heatmap, the centre offset
(2), z (1), log dims (3), yaw as (cos, sin) (2) and velocity (2). NHWC at the
interface, as the JAX module: each prediction is [B, H, W, n].

``center_head_decode``: a 3x3 local-maximum NMS on sigmoid(heatmap) (max
pool with -inf padding, flax's "SAME") and a per-task top-k over the
(H, W, nc) flatten (``idx = pixel * nc + class``, the lower index first
among equal scores, as ``lax.top_k``), merged into padded detections.
``center_head_loss`` is JAX's: a single-cell heatmap target at each GT
centre (not the reference's gaussian splat) with the focal heatmap loss,
and L1 on the box parameters at the centre cell, both normalised by the
in-range GT count of the whole batch. Plain PyTorch, as JAX's is plain XLA.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.nms import top_k
from ..layers import Conv2dBN

BRANCHES = (("heatmap", None), ("reg", 2), ("height", 1), ("dim", 3), ("rot", 2), ("vel", 2))


class _Branch(nn.Module):
    def __init__(self, cin: int, out: int, head_conv: int = 64):
        super().__init__()
        self.conv = Conv2dBN(cin, head_conv, 3, padding=1)
        self.out = nn.Conv2d(head_conv, out, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(self.conv(x))


class CenterHead(nn.Module):
    def __init__(self, in_channels: int, num_classes: Sequence[int] = (1, 2, 2, 1, 2, 2),
                 share_conv_channel: int = 64):
        super().__init__()
        self.num_classes = tuple(int(n) for n in num_classes)
        c = share_conv_channel
        self.shared = Conv2dBN(in_channels, c, 3, padding=1)
        self.tasks = nn.ModuleList(
            nn.ModuleDict({name: _Branch(c, nc if n is None else n) for name, n in BRANCHES})
            for nc in self.num_classes)

    def forward(self, bev: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        """bev [B, H, W, C] -> per task {"heatmap" [B, H, W, nc], "reg",
        "height", "dim", "rot", "vel" [B, H, W, n]}."""
        x = self.shared(bev.permute(0, 3, 1, 2))
        return [{name: branch(x).permute(0, 2, 3, 1) for name, branch in task.items()}
                for task in self.tasks]


@dataclass(frozen=True)
class CenterTestCfg:
    out_size_factor: int = 8
    voxel_size: Tuple[float, float] = (0.1, 0.1)
    pc_range: Tuple[float, float] = (-51.2, -51.2)
    max_per_task: int = 83
    score_threshold: float = 0.1


def _at(p: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """p [B, H, W, d], pix [B, K] flat (y, x) cells -> [B, K, d]."""
    B, H, W, d = p.shape
    return torch.gather(p.reshape(B, H * W, d), 1, pix[..., None].expand(*pix.shape, d))


def center_head_decode(preds: List[Dict[str, torch.Tensor]], cfg: CenterTestCfg):
    """Local-max NMS + per-task top-``max_per_task`` -> {"box3d_lidar" [B, D,
    9] (x, y, z, w, l, h, vx, vy, yaw), "scores", "label_preds" (int32,
    classes numbered across the tasks), "det_valid" (score >=
    ``score_threshold``)}, D = tasks x max_per_task."""
    boxes_all, scores_all, labels_all, valid_all = [], [], [], []
    offset = 0
    f = cfg.out_size_factor
    for p in preds:
        B, H, W, nc = p["heatmap"].shape
        prob = torch.sigmoid(p["heatmap"].permute(0, 3, 1, 2))
        pooled = F.max_pool2d(prob, 3, stride=1, padding=1)  # -inf padding, flax's "SAME"
        peaks = torch.where(prob == pooled, prob, torch.zeros((), device=prob.device))
        scores, idx = top_k(peaks.permute(0, 2, 3, 1).reshape(B, H * W * nc), cfg.max_per_task)
        cls = idx % nc
        pix = torch.div(idx, nc, rounding_mode="floor")
        py, px = torch.div(pix, W, rounding_mode="floor"), pix % W
        reg = _at(p["reg"], pix)
        xs = (px.float() + reg[..., 0]) * f * cfg.voxel_size[0] + cfg.pc_range[0]
        ys = (py.float() + reg[..., 1]) * f * cfg.voxel_size[1] + cfg.pc_range[1]
        z = _at(p["height"], pix)[..., 0]
        dim = torch.exp(_at(p["dim"], pix))
        rot = _at(p["rot"], pix)
        vel = _at(p["vel"], pix)
        boxes_all.append(torch.stack([xs, ys, z, dim[..., 0], dim[..., 1], dim[..., 2],
                                      vel[..., 0], vel[..., 1],
                                      torch.atan2(rot[..., 1], rot[..., 0])], dim=-1))
        scores_all.append(scores)
        labels_all.append(cls + offset)
        valid_all.append(scores >= cfg.score_threshold)
        offset += nc
    return {
        "box3d_lidar": torch.cat(boxes_all, dim=1),
        "scores": torch.cat(scores_all, dim=1),
        "label_preds": torch.cat(labels_all, dim=1).to(torch.int32),
        "det_valid": torch.cat(valid_all, dim=1),
    }


def gaussian_radius(h, w, min_overlap=0.5):
    """CornerNet radius (numpy), JAX's ``centerpoint.gaussian_radius``: the
    third root divided by 2, the reference's quirk."""
    a1 = 1
    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(np.maximum(b1**2 - 4 * a1 * c1, 0))) / 2
    a2 = 4
    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 + np.sqrt(np.maximum(b2**2 - 4 * a2 * c2, 0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (b3 + np.sqrt(np.maximum(b3**2 - 4 * a3 * c3, 0))) / 2
    return np.minimum(np.minimum(r1, r2), r3)


def center_head_loss(preds: List[Dict[str, torch.Tensor]], gt_boxes_by_task: List[torch.Tensor],
                     gt_classes_by_task: List[torch.Tensor], cfg: CenterTestCfg,
                     hm_weight: float = 1.0, reg_weight: float = 0.25) -> Dict[str, torch.Tensor]:
    """Per task: GT boxes [B, G, 9] and task-local 1-based classes [B, G]
    (0 = padding) -> {"loss"}: the focal heatmap loss against a one-cell
    target at each in-range GT centre, plus ``reg_weight`` x L1 of (offset,
    z, log dims, cos / sin yaw, velocity) at the centre cell, each divided by
    the batch's in-range GT count (at least 1)."""
    total = 0.0
    eps = 1e-6
    f = cfg.out_size_factor
    for p, gt, gcls in zip(preds, gt_boxes_by_task, gt_classes_by_task):
        B, H, W, nc = p["heatmap"].shape
        gx = (gt[..., 0] - cfg.pc_range[0]) / (f * cfg.voxel_size[0])
        gy = (gt[..., 1] - cfg.pc_range[1]) / (f * cfg.voxel_size[1])
        ix, iy = torch.floor(gx).to(torch.int32), torch.floor(gy).to(torch.int32)
        inb = (gcls > 0) & (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        lin = torch.where(inb, (iy * W + ix) * nc + (gcls - 1), H * W * nc)
        hm_t = torch.zeros(B, H * W * nc + 1, device=gt.device)
        hm_t.scatter_(1, lin.long(), 1.0)  # the sentinel cell takes the misses
        pos = (hm_t[:, :-1] == 1.0).reshape(B, H, W, nc)
        prob = torch.sigmoid(p["heatmap"])
        zero = torch.zeros((), device=prob.device)
        n = torch.clamp(inb.sum(), min=1)
        hm_loss = -(torch.where(pos, (1 - prob) ** 2 * torch.log(prob + eps), zero)
                    + torch.where(~pos, prob ** 2 * torch.log(1 - prob + eps), zero)).sum() / n
        pix = torch.where(inb, iy * W + ix, 0).long()
        tgt = torch.cat([(gx - ix)[..., None], (gy - iy)[..., None], gt[..., 2:3],
                         torch.log(torch.clamp(gt[..., 3:6], min=1e-3)),
                         torch.cos(gt[..., 8:9]), torch.sin(gt[..., 8:9]), gt[..., 6:8]], dim=-1)
        pred_vec = torch.cat([_at(p[name], pix) for name in ("reg", "height", "dim", "rot",
                                                             "vel")], dim=-1)
        reg_loss = (torch.abs(pred_vec - tgt) * inb[..., None]).sum() / n
        total = total + hm_weight * hm_loss + reg_weight * reg_loss
    return {"loss": total}
