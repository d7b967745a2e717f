"""Scatter-free rotated IoU (port of ``dal3d_tpu/ops/rotated_iou_fast.py``:
``rotated_iou_matrix_fast`` and ``boxes_iou3d_fast``), plain PyTorch on the
input tensor's device.

The intersection of two rotated rectangles, elementwise over every pair:

1. candidate vertices of the intersection polygon: the corners of A inside
   B (4), the corners of B inside A (4) and every proper edge-edge
   intersection (16), 24 candidates with masks;
2. the candidates sorted by a pseudo-angle around their valid mean with a
   fixed bitonic compare-exchange network of 32 (invalid ones get the key
   1e9 and sort to the end). The network is JAX's, not ``torch.sort``: it
   leaves equal-angle candidates in JAX's order;
3. invalid slots replaced by the first (angular-min) vertex, so the
   triangle fan ignores them, and the fan's area summed.

The intersection is bounded by the smaller area (volume), as in JAX: a
degenerate pair (coincident edges) can over-count it. No Pallas kernel in
JAX; the Green's-theorem variant of the JAX module is not ported (ROADMAP
A9.e).

Boxes: BEV [x, y, w, l, yaw] for the matrix, [x, y, z, w, l, h, ..., yaw]
(z at the bottom face) for the 3D IoU; corners as ``core.box_ops.corners_2d``.
"""
from __future__ import annotations

import torch

from ..core.box_ops import corners_2d

_NCAND = 24
_PADDED = 32  # bitonic network size
_INVALID = 1e9


def _point_in_quad(p: torch.Tensor, quad: torch.Tensor) -> torch.Tensor:
    """p [..., 2], quad [..., 4, 2] -> bool [...]: inside (sign-consistent)."""
    a = quad
    b = torch.roll(quad, -1, dims=-2)
    s = (b[..., 0] - a[..., 0]) * (p[..., None, 1] - a[..., 1]) - (
        b[..., 1] - a[..., 1]) * (p[..., None, 0] - a[..., 0])
    return (s >= -1e-9).all(-1) | (s <= 1e-9).all(-1)


def _edge_intersections(c1: torch.Tensor, c2: torch.Tensor):
    """All 16 edge-pair intersection points: c1, c2 [..., 4, 2] ->
    (pts [..., 16, 2], valid [..., 16])."""
    a0 = c1[..., :, None, :]  # [..., 4, 1, 2]
    a1 = torch.roll(c1, -1, dims=-2)[..., :, None, :]
    b0 = c2[..., None, :, :]  # [..., 1, 4, 2]
    b1 = torch.roll(c2, -1, dims=-2)[..., None, :, :]
    da = a1 - a0
    db = b1 - b0
    denom = da[..., 0] * db[..., 1] - da[..., 1] * db[..., 0]
    dp = b0 - a0
    safe = torch.where(torch.abs(denom) < 1e-12, torch.ones_like(denom), denom)
    t = (dp[..., 0] * db[..., 1] - dp[..., 1] * db[..., 0]) / safe
    u = (dp[..., 0] * da[..., 1] - dp[..., 1] * da[..., 0]) / safe
    valid = (torch.abs(denom) > 1e-12) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    pts = a0 + t[..., None] * da
    shp = pts.shape[:-3]
    return pts.reshape(*shp, 16, 2), valid.reshape(*shp, 16)


def _bitonic_sort_by_key(keys: torch.Tensor, vals: torch.Tensor):
    """Fixed bitonic network over the last axis of ``keys`` [..., L] (L a
    power of two), carrying ``vals`` [..., L, 2]; ascending by key. Each
    stage keeps the first or the second of a compare-exchange pair by JAX's
    rule, so equal keys end where JAX's network puts them."""
    L = keys.shape[-1]
    idx = torch.arange(L, device=keys.device)
    k = 2
    while k <= L:
        j = k // 2
        while j >= 1:
            partner = idx ^ j
            ascending = (idx & k) == 0
            k1 = keys
            k2 = keys[..., partner]
            v2 = vals[..., partner, :]
            keep_first = torch.where(
                idx < partner,
                torch.where(ascending, k1 <= k2, k1 >= k2),
                torch.where(ascending, k2 <= k1, k2 >= k1))
            keys = torch.where(keep_first, k1, k2)
            vals = torch.where(keep_first[..., None], vals, v2)
            j //= 2
        k *= 2
    return keys, vals


def _pair_intersection_area(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """c1, c2 [..., 4, 2] (broadcast) -> intersection area [...]."""
    c1, c2 = torch.broadcast_tensors(c1, c2)
    vA = _point_in_quad(c1, c2[..., None, :, :])  # corners of A inside B
    vB = _point_in_quad(c2, c1[..., None, :, :])
    inter_pts, inter_valid = _edge_intersections(c1, c2)

    pts = torch.cat([c1, c2, inter_pts], dim=-2)  # [..., 24, 2]
    valid = torch.cat([vA, vB, inter_valid], dim=-1)  # [..., 24]
    n_valid = valid.sum(-1)

    # pseudo-angle around the valid mean: monotone in atan2 over [0, 4)
    denom = torch.clamp(n_valid, min=1)[..., None].to(pts.dtype)
    center = (pts * valid[..., None]).sum(-2) / denom
    rel = pts - center[..., None, :]
    dx, dy = rel[..., 0], rel[..., 1]
    r = dx / (torch.abs(dx) + torch.abs(dy) + 1e-12)
    ang = torch.where(dy >= 0, 1.0 - r, 3.0 + r)
    keys = torch.where(valid, ang, torch.full_like(ang, _INVALID))
    pad = _PADDED - _NCAND
    keys = torch.cat([keys, keys.new_full((*keys.shape[:-1], pad), _INVALID)], dim=-1)
    pts_p = torch.cat([pts, pts.new_zeros((*pts.shape[:-2], pad, 2))], dim=-2)
    keys_s, pts_s = _bitonic_sort_by_key(keys, pts_p)

    # invalid slots -> the first valid vertex (no triangle-fan contribution)
    first = pts_s[..., 0:1, :]
    ok = keys_s < 1e8
    ring = torch.where(ok[..., None], pts_s, first)
    v = ring - first
    nxt = torch.roll(v, -1, dims=-2)
    cross = v[..., 0] * nxt[..., 1] - nxt[..., 0] * v[..., 1]
    area = 0.5 * torch.abs(cross.sum(-1))
    return torch.where(n_valid >= 3, area, torch.zeros_like(area))


def rotated_iou_matrix_fast(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Rotated BEV IoU matrix [N, M] of boxes [N, 5] and [M, 5] (x, y, w, l,
    yaw)."""
    inter = _pair_intersection_area(corners_2d(boxes1)[:, None], corners_2d(boxes2)[None, :])
    area1 = torch.abs(boxes1[:, 2] * boxes1[:, 3])
    area2 = torch.abs(boxes2[:, 2] * boxes2[:, 3])
    # physical bound: inter <= min(areas) (a coincident-edge pair can
    # over-count the intersection and blow the IoU up)
    inter = torch.minimum(inter, torch.minimum(area1[:, None], area2[None, :]))
    union = area1[:, None] + area2[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def boxes_iou3d_fast(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """3D IoU [N, M] of boxes [N, >=7] and [M, >=7] (x, y, z, w, l, h, ...,
    yaw; z at the bottom face) through the scatter-free BEV intersection."""
    bev1 = torch.stack([boxes1[:, 0], boxes1[:, 1], boxes1[:, 3], boxes1[:, 4],
                        boxes1[:, -1]], -1)
    bev2 = torch.stack([boxes2[:, 0], boxes2[:, 1], boxes2[:, 3], boxes2[:, 4],
                        boxes2[:, -1]], -1)
    inter_bev = _pair_intersection_area(corners_2d(bev1)[:, None], corners_2d(bev2)[None, :])
    z1lo, z1hi = boxes1[:, 2], boxes1[:, 2] + boxes1[:, 5]
    z2lo, z2hi = boxes2[:, 2], boxes2[:, 2] + boxes2[:, 5]
    zov = torch.clamp(torch.minimum(z1hi[:, None], z2hi[None, :])
                      - torch.maximum(z1lo[:, None], z2lo[None, :]), min=0.0)
    inter = inter_bev * zov
    vol1 = torch.abs(boxes1[:, 3] * boxes1[:, 4] * boxes1[:, 5])
    vol2 = torch.abs(boxes2[:, 3] * boxes2[:, 4] * boxes2[:, 5])
    inter = torch.minimum(inter, torch.minimum(vol1[:, None], vol2[None, :]))
    union = vol1[:, None] + vol2[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))
