"""Device-side 3D box geometry in torch (port of
``dal3d_tpu/core/box_ops_jax.py``): residual box coding, and the
nearest-axis-aligned IoU the target assignment matches anchors with."""
from __future__ import annotations

import math

import torch


def limit_period(val: torch.Tensor, offset: float = 0.5, period: float = math.pi) -> torch.Tensor:
    return val - torch.floor(val / period + offset) * period


def second_box_encode(boxes: torch.Tensor, anchors: torch.Tensor,
                      encode_angle_to_vector: bool = False,
                      smooth_dim: bool = False) -> torch.Tensor:
    """boxes / anchors [..., 7|9] -> encodings [..., code_size]."""
    ndim = anchors.shape[-1]
    xa, ya, za, wa, la, ha = (anchors[..., i] for i in range(6))
    xg, yg, zg, wg, lg, hg = (boxes[..., i] for i in range(6))
    ra, rg = anchors[..., -1], boxes[..., -1]

    diagonal = torch.sqrt(la ** 2 + wa ** 2)
    xt = (xg - xa) / diagonal
    yt = (yg - ya) / diagonal
    zt = (zg - za) / ha
    if smooth_dim:
        lt, wt, ht = lg / la - 1, wg / wa - 1, hg / ha - 1
    else:
        lt, wt, ht = torch.log(lg / la), torch.log(wg / wa), torch.log(hg / ha)
    ret = [xt, yt, zt, wt, lt, ht]
    if ndim > 7:
        ret.append(boxes[..., 6] - anchors[..., 6])
        ret.append(boxes[..., 7] - anchors[..., 7])
    if encode_angle_to_vector:
        ret.extend([torch.cos(rg) - torch.cos(ra), torch.sin(rg) - torch.sin(ra)])
    else:
        ret.append(rg - ra)
    return torch.stack(ret, dim=-1)


def second_box_decode(box_encodings: torch.Tensor, anchors: torch.Tensor,
                      encode_angle_to_vector: bool = False,
                      smooth_dim: bool = False) -> torch.Tensor:
    """Residual decode of [..., code] encodings against [..., 7|9] anchors."""
    ndim = anchors.shape[-1]
    xa, ya, za, wa, la, ha = (anchors[..., i] for i in range(6))
    ra = anchors[..., -1]
    xt, yt, zt, wt, lt, ht = (box_encodings[..., i] for i in range(6))

    diagonal = torch.sqrt(la ** 2 + wa ** 2)
    xg = xt * diagonal + xa
    yg = yt * diagonal + ya
    zg = zt * ha + za
    if smooth_dim:
        lg, wg, hg = (lt + 1) * la, (wt + 1) * wa, (ht + 1) * ha
    else:
        lg, wg, hg = torch.exp(lt) * la, torch.exp(wt) * wa, torch.exp(ht) * ha
    ret = [xg, yg, zg, wg, lg, hg]
    if ndim > 7:
        ret.append(box_encodings[..., 6] + anchors[..., 6])
        ret.append(box_encodings[..., 7] + anchors[..., 7])
        ang = box_encodings[..., 8:]
    else:
        ang = box_encodings[..., 6:]
    if encode_angle_to_vector:
        rg = torch.atan2(ang[..., 1] + torch.sin(ra), ang[..., 0] + torch.cos(ra))
    else:
        rg = ang[..., 0] + ra
    ret.append(rg)
    return torch.stack(ret, dim=-1)


def center_to_minmax_2d(centers: torch.Tensor, dims: torch.Tensor) -> torch.Tensor:
    return torch.cat([centers - dims / 2, centers + dims / 2], dim=-1)


def rbbox2d_to_near_bbox(rbboxes: torch.Tensor) -> torch.Tensor:
    """[..., 5] (x, y, w, l, r) -> [..., 4] nearest axis-aligned bbox."""
    rots = rbboxes[..., -1]
    rots_0_pi_div_2 = torch.abs(limit_period(rots, 0.5, math.pi))
    cond = (rots_0_pi_div_2 > math.pi / 4)[..., None]
    swapped = torch.stack(
        [rbboxes[..., 0], rbboxes[..., 1], rbboxes[..., 3], rbboxes[..., 2]], dim=-1)
    bboxes_center = torch.where(cond, swapped, rbboxes[..., :4])
    return center_to_minmax_2d(bboxes_center[..., :2], bboxes_center[..., 2:4])


def pairwise_iou_aa(boxes: torch.Tensor, query_boxes: torch.Tensor,
                    eps: float = 0.0) -> torch.Tensor:
    """Axis-aligned 2D IoU matrix [..., N, K] of (xmin, ymin, xmax, ymax)
    boxes [..., N, 4] and [..., K, 4] (leading dims broadcast)."""
    b = boxes[..., :, None, :]
    q = query_boxes[..., None, :, :]
    iw = torch.minimum(b[..., 2], q[..., 2]) - torch.maximum(b[..., 0], q[..., 0]) + eps
    ih = torch.minimum(b[..., 3], q[..., 3]) - torch.maximum(b[..., 1], q[..., 1]) + eps
    zero = torch.zeros((), dtype=iw.dtype, device=iw.device)
    inter = torch.where((iw > 0) & (ih > 0), iw * ih, zero)
    area_b = (b[..., 2] - b[..., 0] + eps) * (b[..., 3] - b[..., 1] + eps)
    area_q = (q[..., 2] - q[..., 0] + eps) * (q[..., 3] - q[..., 1] + eps)
    union = area_b + area_q - inter
    return torch.where(inter > 0, inter / union, zero)


def nearest_iou_similarity(boxes1_rbv: torch.Tensor, boxes2_rbv: torch.Tensor) -> torch.Tensor:
    """NearestIouSimilarity: rotated BEV boxes [..., N, 5] / [..., K, 5] ->
    axis-aligned-nearest IoU matrix [..., N, K]."""
    return pairwise_iou_aa(rbbox2d_to_near_bbox(boxes1_rbv), rbbox2d_to_near_bbox(boxes2_rbv),
                           eps=0.0)


def corners_2d(boxes_bev: torch.Tensor) -> torch.Tensor:
    """Rotated BEV boxes [..., 5] (x, y, w, l, r) -> corners [..., 4, 2],
    counterclockwise as in ``box_np_ops.center_to_corner_box2d``."""
    x, y, w, l, r = (boxes_bev[..., i] for i in range(5))
    dx = torch.stack([-w / 2, -w / 2, w / 2, w / 2], dim=-1)
    dy = torch.stack([-l / 2, l / 2, l / 2, -l / 2], dim=-1)
    cos, sin = torch.cos(r)[..., None], torch.sin(r)[..., None]
    cx = dx * cos + dy * sin
    cy = -dx * sin + dy * cos
    return torch.stack([cx + x[..., None], cy + y[..., None]], dim=-1)
