"""TransFusion detection head and its loss (port of
``dal3d_tpu/models/bevfusion/transfusion.py``).

Dense heatmap on the BEV map; class-aware local-maximum NMS (3x3 max-pool
equality, the padding ring excluded, nuScenes classes 8 and 9 raw) and the
top-``num_proposals`` queries over the class-major flatten; one post-norm
transformer decoder layer (query self-attention, cross-attention to the
flattened BEV map, learned positional encodings added to q, k and v); BN'd
prediction FFNs; decode to lidar-frame boxes.

Layouts follow the flax modules, so the weights bridge maps them one to one:
``nn.Dense`` kernels [in, out] become ``nn.Linear`` weights [out, in];
attention keeps flax's query / key / value / out projections (each head's
d/heads slice side by side) and scales by 1/sqrt(d/heads); LayerNorm eps is
flax's 1e-6; BN eps 1e-5 and momentum 0.1 (flax 0.9). The query features are
gathered with the row-gather kernel (``ops/gather.py::gather_rows``).

Training: the decoder's dropout (0.1, as JAX's) draws its masks from the
generator a train step hands it (``Dropout.generator``), seeded from the step
as JAX's ``fold_in(PRNGKey(0), step)``, so a resumed run draws the same
masks again (JAX's own bits cannot be matched). ``transfusion_loss`` is the
Hungarian-matched loss: its matching is ``ops/lsa.py`` (a kernel on the
card), its IoU cost ``ops/rotated_iou.py::boxes_iou3d`` (plain PyTorch).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import gather as _gather
from ...ops import lsa as _lsa
from ...ops.nms import top_k
from ...ops.rotated_iou import boxes_iou3d
from ...parallel.dist import shared_normaliser
from ..layers import BatchNorm2d, BatchNormLast
from ..losses.losses import sigmoid_focal_loss
from .gaussian import draw_gaussian_heatmap, gaussian_focal_loss, gaussian_radius


class PositionEmbeddingLearned(nn.Module):
    """Linear(2, d) + BN + ReLU + Linear(d, d) over [B, N, 2]."""

    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(2, dim)
        self.bn = BatchNormLast(dim, eps=1e-5, momentum=0.1)
        self.fc2 = nn.Linear(dim, dim)

    def forward(self, xy: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.bn(self.fc1(xy))))


class PredFFN(nn.Module):
    """One prediction branch: Linear(d, 64, no bias) + BN + ReLU +
    Linear(64, out)."""

    def __init__(self, dim: int, out: int, head_conv: int = 64):
        super().__init__()
        self.conv0 = nn.Linear(dim, head_conv, bias=False)
        self.bn0 = BatchNormLast(head_conv, eps=1e-5, momentum=0.1)
        self.out = nn.Linear(head_conv, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(torch.relu(self.bn0(self.conv0(x))))


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention``: per-head projections with
    biases, softmax(q k^T / sqrt(d/heads)) v, an output projection."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, q_in: torch.Tensor, k_in: torch.Tensor, v_in: torch.Tensor) -> torch.Tensor:
        B, P, d = q_in.shape
        L = k_in.shape[1]
        h = self.heads
        dh = d // h
        q = self.query(q_in).view(B, P, h, dh) / math.sqrt(dh)
        k = self.key(k_in).view(B, L, h, dh)
        v = self.value(v_in).view(B, L, h, dh)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, P, d))


class Dropout(nn.Module):
    """flax's ``nn.Dropout`` in train mode: keep with probability 1 - p and
    scale the kept values by 1 / (1 - p); the identity in eval mode. The
    masks come from ``generator`` when one is set (the train step's), else
    from torch's default generator."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.p
        return torch.where(keep, x / (1.0 - self.p), torch.zeros((), dtype=x.dtype,
                                                                device=x.device))


class DecoderLayer(nn.Module):
    """Post-norm transformer decoder layer; positional encodings are added to
    q, k and v in both attentions."""

    def __init__(self, dim: int = 128, heads: int = 8, ffn_dim: int = 256,
                 dropout: float = 0.1):
        super().__init__()
        self.self_attn = MultiHeadAttention(dim, heads)
        self.cross_attn = MultiHeadAttention(dim, heads)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ffn1 = nn.Linear(dim, ffn_dim)
        self.ffn2 = nn.Linear(ffn_dim, dim)
        self.drop = Dropout(dropout)

    def forward(self, q, q_pos, kv, kv_pos):
        """q [B, P, C], kv [B, HW, C] with their positional encodings."""
        qe = q + q_pos
        q = self.norm1(q + self.drop(self.self_attn(qe, qe, qe)))
        ke = kv + kv_pos
        q = self.norm2(q + self.drop(self.cross_attn(q + q_pos, ke, ke)))
        y = self.ffn2(self.drop(torch.relu(self.ffn1(q))))
        return self.norm3(q + self.drop(y))


class TransFusionHead(nn.Module):
    PRED = (("center", 2), ("height", 1), ("dim", 3), ("rot", 2), ("vel", 2))

    def __init__(self, in_channels: int, num_classes: int = 10, num_proposals: int = 200,
                 hidden_channel: int = 128, num_heads: int = 8, ffn_channel: int = 256,
                 nms_kernel_size: int = 3):
        super().__init__()
        d, nc = hidden_channel, num_classes
        self.num_classes, self.num_proposals = nc, num_proposals
        self.nms_kernel_size = nms_kernel_size
        self.shared_conv = nn.Conv2d(in_channels, d, 3, padding=1, bias=True)
        self.heatmap_conv = nn.Conv2d(d, d, 3, padding=1, bias=False)
        self.heatmap_bn = BatchNorm2d(d, eps=1e-5, momentum=0.1)
        self.heatmap_out = nn.Conv2d(d, nc, 3, padding=1, bias=True)
        self.class_encoding = nn.Linear(nc, d)
        self.self_posembed = PositionEmbeddingLearned(d)
        self.cross_posembed = PositionEmbeddingLearned(d)
        self.decoder0 = DecoderLayer(d, num_heads, ffn_channel)
        for name, n in self.PRED:
            setattr(self, f"pred_{name}", PredFFN(d, n))
        self.pred_heatmap = PredFFN(d, nc)

    def forward(self, bev: torch.Tensor) -> Dict[str, torch.Tensor]:
        """bev [B, H, W, C] -> per-proposal predictions + heatmap [B, H, W, nc]
        (BEV rows are y-cells, columns x-cells; the positional MLPs get
        (x + 0.5, y + 0.5), as the JAX head)."""
        B, H, W, _ = bev.shape
        P, nc, d = self.num_proposals, self.num_classes, self.shared_conv.out_channels
        x = self.shared_conv(bev.permute(0, 3, 1, 2))  # NCHW
        h = torch.relu(self.heatmap_bn(self.heatmap_conv(x)))
        heatmap = self.heatmap_out(h)  # [B, nc, H, W]

        # query init: local-max NMS with the padding ring excluded, top-P over
        # the class-major flatten (NCHW is already class-major)
        prob = torch.sigmoid(heatmap)
        k = self.nms_kernel_size
        pad = k // 2
        pooled = F.max_pool2d(prob, k, stride=1, padding=pad)  # pads with -inf, as "SAME"
        yy = torch.arange(H, device=bev.device)[:, None]
        xx = torch.arange(W, device=bev.device)[None, :]
        inner = (yy >= pad) & (yy < H - pad) & (xx >= pad) & (xx < W - pad)
        local_max = torch.where(inner, pooled, torch.zeros((), device=bev.device))
        if nc == 10:  # nuScenes pedestrian and traffic_cone keep their raw peaks
            local_max = torch.cat([local_max[:, :8], prob[:, 8:]], dim=1)
        masked = prob * (prob == local_max)
        top_scores, top_idx = top_k(masked.reshape(B, nc * H * W), P)
        cls_id = torch.div(top_idx, H * W, rounding_mode="floor")
        pix = top_idx - cls_id * (H * W)
        qy = torch.div(pix, W, rounding_mode="floor")
        qx = pix - qy * W

        # (y, x) row order; a view of the NCHW map, which the row gather reads in place
        feat_flat = x.permute(0, 2, 3, 1).reshape(B, H * W, d)
        rows = pix + (torch.arange(B, device=bev.device) * (H * W))[:, None]
        q_feat = _gather.gather_rows(feat_flat, rows.reshape(-1).to(torch.int32)).view(B, P, d)
        q_feat = q_feat + self.class_encoding(F.one_hot(cls_id, nc).to(q_feat.dtype))

        q_xy = torch.stack([qx, qy], dim=-1).to(torch.float32) + 0.5
        kv_xy = torch.stack([torch.broadcast_to(xx, (H, W)).reshape(-1),
                             torch.broadcast_to(yy, (H, W)).reshape(-1)], dim=-1)
        # every sample has the same key positions; in eval and in train mode
        # (duplicated rows leave the batch statistics as they are) one row of
        # encodings serves the batch
        kv_pos = self.cross_posembed(kv_xy.to(torch.float32)[None] + 0.5).expand(B, -1, -1)
        q_pos = self.self_posembed(q_xy)
        q = self.decoder0(q_feat, q_pos, feat_flat, kv_pos)

        out = {name: getattr(self, f"pred_{name}")(q) for name, _ in self.PRED}
        out["center"] = out["center"] + q_xy
        out.update(cls_logits=self.pred_heatmap(q), heatmap=heatmap.permute(0, 2, 3, 1),
                   query_labels=cls_id.to(torch.int32), query_score=top_scores)
        return out


@dataclass(frozen=True)
class TransFusionTestCfg:
    out_size_factor: int = 8
    voxel_size: Tuple[float, float] = (0.075, 0.075)
    pc_range: Tuple[float, float] = (-54.0, -54.0)
    score_threshold: float = 0.0
    max_detections: int = 200


def transfusion_decode(preds: Dict[str, torch.Tensor], cfg: TransFusionTestCfg):
    """Proposals -> lidar-frame boxes [B, P, 9] (x, y, z, w, l, h, vx, vy,
    yaw), scores, labels and validity. Each proposal keeps its query's class;
    its score is sigmoid(logit at that class) x the query's heatmap score."""
    vx, vy = cfg.voxel_size
    f = cfg.out_size_factor
    cx = preds["center"][..., 0] * f * vx + cfg.pc_range[0]
    cy = preds["center"][..., 1] * f * vy + cfg.pc_range[1]
    w, l, h = (torch.exp(preds["dim"][..., i]) for i in range(3))
    yaw = torch.atan2(preds["rot"][..., 1], preds["rot"][..., 0])
    z = preds["height"][..., 0]
    boxes = torch.stack([cx, cy, z, w, l, h, preds["vel"][..., 0], preds["vel"][..., 1], yaw],
                        dim=-1)
    labels = preds["query_labels"]
    probs = torch.sigmoid(preds["cls_logits"])
    scores = torch.gather(probs, -1, labels[..., None].long())[..., 0] * preds["query_score"]
    return {"box3d_lidar": boxes, "scores": scores, "label_preds": labels,
            "det_valid": scores > cfg.score_threshold}


def transfusion_loss(preds: Dict[str, torch.Tensor], gt_boxes: torch.Tensor,
                     gt_classes: torch.Tensor, cfg: TransFusionTestCfg,
                     cls_weight: float = 1.0, bbox_weight: float = 0.25,
                     heatmap_weight: float = 1.0,
                     code_weights: Tuple[float, ...] = (1.0,) * 8 + (0.2, 0.2),
                     gaussian_overlap: float = 0.1, min_radius: int = 2,
                     cost_cls_weight: float = 0.15, cost_reg_weight: float = 0.25,
                     cost_iou_weight: float = 0.25) -> Dict[str, torch.Tensor]:
    """Hungarian-matched TransFusion losses (JAX's ``transfusion_loss``):
    preds of ``TransFusionHead``, gt_boxes [B, G, 9] (lidar frame, padded),
    gt_classes [B, G] global 1-based (0 = padding).

    Matching cost FocalLossCost x 0.15 + BEV-L1 x 0.25 - IoU3D x 0.25 (BEV
    centres normalised by each axis's own extent, taken from the heatmap
    grid; the IoU on bottom-centred boxes), 1e6 on padded GT, solved without
    a gradient; then the focal classification loss (matched proposals to
    their GT class, the others to background), the code-weighted L1 on the
    matched proposals' raw regression targets, and the gaussian focal
    heatmap loss. Returns loss, cls_loss, reg_loss, heatmap_loss and
    num_matched (this batch's).

    The classification and regression losses are divided by the matched
    count and the heatmap loss by the in-range GT count of the global batch:
    in a world of several ranks each is the rank's sum over
    ``parallel.dist.shared_normaliser``, so that the mean over the ranks is
    the global batch's loss."""
    B, P = preds["center"].shape[:2]
    G = gt_boxes.shape[1]
    nc = preds["cls_logits"].shape[-1]
    dev = gt_boxes.device
    gt_valid = gt_classes > 0
    gcls = torch.clamp(gt_classes.long() - 1, 0, nc - 1)
    pc_range = torch.tensor(cfg.pc_range, dtype=torch.float32, device=dev)
    voxel = torch.tensor(cfg.voxel_size, dtype=torch.float32, device=dev)
    f = cfg.out_size_factor

    with torch.no_grad():  # the assignment's cost is a stopped gradient
        boxes = transfusion_decode(preds, cfg)["box3d_lidar"]
        probs = torch.sigmoid(preds["cls_logits"])
        eps, alpha, gamma = 1e-8, 0.25, 2.0
        pos_cost = -torch.log(probs + eps) * alpha * torch.pow(1 - probs, gamma)
        neg_cost = -torch.log(1 - probs + eps) * (1 - alpha) * torch.pow(probs, gamma)
        focal_tbl = pos_cost - neg_cost  # [B, P, nc]
        cls_cost = torch.gather(focal_tbl, 2, gcls[:, None, :].expand(B, P, G))
        hm_h, hm_w = preds["heatmap"].shape[1:3]
        span = torch.tensor([hm_w * f * cfg.voxel_size[0], hm_h * f * cfg.voxel_size[1]],
                            dtype=torch.float32, device=dev)
        nb = (boxes[..., :2] - pc_range) / span
        ng = (gt_boxes[..., :2] - pc_range) / span
        reg_cost = (nb[:, :, None] - ng[:, None, :]).abs().sum(-1)

        def to_bottom(b):
            return torch.cat([b[..., :2], b[..., 2:3] - b[..., 5:6] / 2, b[..., 3:]], -1)

        iou = torch.stack([boxes_iou3d(to_bottom(boxes[b]), to_bottom(gt_boxes[b]))
                           for b in range(B)])  # [B, P, G]
        cost = cost_cls_weight * cls_cost + cost_reg_weight * reg_cost - cost_iou_weight * iou
        cost = torch.where(gt_valid[:, None, :], cost, torch.full((), 1e6, device=dev))
        col4row = _lsa.linear_sum_assignment(cost.transpose(1, 2))  # [B, G]
        gidx = torch.where(gt_valid, torch.arange(G, device=dev)[None], -1)
        # col4row may be -1 (more GT rows than proposals): that write is dropped
        assign = torch.full((B, P + 1), -1, dtype=torch.long, device=dev)
        assign.scatter_(1, torch.where(col4row >= 0, col4row.long(), P), gidx)
        assign = assign[:, :P]
    matched = assign >= 0
    n_matched = matched.sum()
    norm = shared_normaliser(n_matched).float()  # the global batch's matches
    safe = torch.clamp(assign, min=0)
    tgt_boxes = torch.gather(gt_boxes, 1, safe[..., None].expand(B, P, gt_boxes.shape[-1]))
    tgt_cls = torch.gather(gt_classes.long(), 1, safe)

    one_hot = F.one_hot(torch.where(matched, tgt_cls - 1, nc), nc + 1)[..., :nc].float()
    cls_loss = sigmoid_focal_loss(preds["cls_logits"], one_hot,
                                  torch.ones(B, P, device=dev), gamma=2.0,
                                  alpha=0.25).sum() / norm

    tgt = torch.cat([(tgt_boxes[..., :2] - pc_range) / (f * voxel), tgt_boxes[..., 2:3],
                     torch.log(torch.clamp(tgt_boxes[..., 3:6], min=1e-3)),
                     torch.cos(tgt_boxes[..., 8:9]), torch.sin(tgt_boxes[..., 8:9]),
                     tgt_boxes[..., 6:8]], -1)
    pred_vec = torch.cat([preds["center"], preds["height"], preds["dim"], preds["rot"],
                          preds["vel"]], -1)
    cw = torch.tensor(code_weights, dtype=pred_vec.dtype, device=dev)
    reg_loss = ((pred_vec - tgt).abs() * cw * matched[..., None]).sum() / norm

    hm = preds["heatmap"]
    Hh, Wh = hm.shape[1:3]
    gx = (gt_boxes[..., 0] - cfg.pc_range[0]) / (f * cfg.voxel_size[0])
    gy = (gt_boxes[..., 1] - cfg.pc_range[1]) / (f * cfg.voxel_size[1])
    w_cells = gt_boxes[..., 3] / cfg.voxel_size[0] / f
    l_cells = gt_boxes[..., 4] / cfg.voxel_size[1] / f
    radius = torch.clamp(torch.floor(gaussian_radius(l_cells, w_cells, gaussian_overlap)).int(),
                         min=min_radius)
    inb = gt_valid & (gx >= 0) & (gx < Wh) & (gy >= 0) & (gy < Hh) & (w_cells > 0) & (l_cells > 0)
    target_hm = draw_gaussian_heatmap(torch.stack([gx, gy], -1), radius, gcls, inb, Hh, Wh, nc)
    hm_loss = gaussian_focal_loss(hm, target_hm).sum() / shared_normaliser(inb.sum()).float()

    total = cls_weight * cls_loss + bbox_weight * reg_loss + heatmap_weight * hm_loss
    return {"loss": total, "cls_loss": cls_loss, "reg_loss": reg_loss, "heatmap_loss": hm_loss,
            "num_matched": n_matched, "assign": assign}
