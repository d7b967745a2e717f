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
JAX.

``rotated_iou_matrix_greens`` is the module's other engine, JAX's
Green's-theorem one: the intersection's area is half the sum of cross(u, v)
over its boundary segments, which are each box's edges Cyrus-Beck-clipped to
the other box; no sort. It is called by name (JAX's ``rotate_nms`` takes
it); the port's NMS takes K2 and its plain twin (``ops/iou_matrix.py``).

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


_EPS = 1e-4  # meters: the Green's engine's parallel / on-boundary band (lidar scale)


def _right_normals(e: torch.Tensor) -> torch.Tensor:
    """Unit right-hand normals (ey, -ex) / |e| of edges e [..., 2]: inward on
    ``corners_2d``'s clockwise rings. Computed in f64 and rounded once to
    e's dtype: the card's f32 ``sqrt`` is not the CPU's in the last bit."""
    ed = e.double()
    elen = torch.sqrt(torch.clamp((ed * ed).sum(-1), min=1e-20))
    return (torch.stack([ed[..., 1], -ed[..., 0]], dim=-1) / elen[..., None]).to(e.dtype)


def _clip_sum(p0, d, num, den) -> torch.Tensor:
    """Σ cross(u, v) of the edges p0 + t d clipped by the planes whose signed
    distances are ``num`` and projections ``den`` ([..., 4 edges, ..., 4
    planes] with the planes last), the edge axis summed: JAX's Cyrus-Beck
    step with its ``_EPS`` classification and the half weight of a segment
    on the clip boundary. p0, d broadcast against ``num[..., 0]`` with a
    trailing xy axis."""
    parallel = den.abs() < _EPS
    t_at = -num / torch.where(parallel, torch.ones_like(den), den)
    is_entry = den > 0  # moving inward
    zero, one = torch.zeros_like(t_at), torch.ones_like(t_at)
    t_lo = torch.where(is_entry & ~parallel, t_at, zero).amax(-1)
    t_hi = torch.where(~is_entry & ~parallel, t_at, one).amin(-1)
    on_boundary = (parallel & (num.abs() <= _EPS)).any(-1)
    killed = (parallel & (num < -_EPS)).any(-1)
    weight = torch.where(on_boundary, 0.5, 1.0).to(t_lo.dtype)
    t_lo, t_hi = torch.clamp(t_lo, 0.0, 1.0), torch.clamp(t_hi, 0.0, 1.0)
    ok = (t_hi > t_lo) & ~killed
    u = p0 + t_lo[..., None] * d
    v = p0 + t_hi[..., None] * d
    cr = u[..., 0] * v[..., 1] - v[..., 0] * u[..., 1]
    return torch.where(ok, cr, torch.zeros_like(cr)) * weight


def _pair_intersection_area_greens(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Green's-theorem intersection area of c1, c2 [..., 4, 2] (broadcast):
    0.5 |Σ cross(u, v)| over A's edges clipped to B and B's clipped to A.
    A segment on the other box's boundary counts half, so coincident edges
    sum to one traversal and edge-only contact cancels to zero area."""
    c1, c2 = torch.broadcast_tensors(c1, c2)

    def contrib(edges_from, clip_to):
        p0 = edges_from  # [..., 4, 2]
        d = torch.roll(edges_from, -1, dims=-2) - p0
        a = clip_to[..., None, :, :]  # [..., 1, 4, 2] clip edges
        n = _right_normals(torch.roll(clip_to, -1, dims=-2) - clip_to)[..., None, :, :]
        num = (n * (p0[..., :, None, :] - a)).sum(-1)  # [..., 4 edges, 4 planes]
        den = (n * d[..., :, None, :]).sum(-1)
        return _clip_sum(p0, d, num, den).sum(-1)

    return 0.5 * torch.abs(contrib(c1, c2) + contrib(c2, c1))


def _clip_planes(c: torch.Tensor):
    """Clip planes of clockwise corner rings [M, 4, 2]: inward unit normals
    n [M, 4, 2] and offsets a.n [M, 4], once per box rather than per pair."""
    n = _right_normals(torch.roll(c, -1, dims=-2) - c)
    return n, (n * c).sum(-1)


def _matrix_contrib(cf: torch.Tensor, n: torch.Tensor, an: torch.Tensor) -> torch.Tensor:
    """Σ cross(u, v) of ``cf``'s edges [N, 4, 2] clipped to every box of
    planes (n [M, 4, 2], an [M, 4]) -> [N, M]. The plane dots are written
    out in f32 (JAX's contraction at HIGHEST precision; no TF32)."""
    p0 = cf
    d = torch.roll(cf, -1, dims=-2) - p0

    def dots(x):  # [N, 4, 2] . [M, 4, 2] -> [N, 4e, M, 4p]
        return (x[:, :, None, None, 0] * n[None, None, :, :, 0]
                + x[:, :, None, None, 1] * n[None, None, :, :, 1])

    num = dots(p0) - an[None, None]
    den = dots(d)
    return _clip_sum(p0[:, :, None], d[:, :, None], num, den).sum(1)


def rotated_iou_matrix_greens(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Rotated BEV IoU matrix [N, M] of boxes [N, 5] and [M, 5] (x, y, w, l,
    yaw) by the Green's-theorem engine, plain PyTorch on the boxes' device.

    The corners and the planes' unit normals are computed in f64 and
    rounded once to f32, so that they do not depend on the device's f32
    sin, cos and sqrt (the card's and the CPU's differ in the last bit, and
    one ulp of a corner moves an IoU of near-coincident candidate boxes by
    up to 5e-4); the rest is JAX's f32 arithmetic."""
    c1, c2 = corners_2d(boxes1.double()).float(), corners_2d(boxes2.double()).float()
    n1, an1 = _clip_planes(c1)
    n2, an2 = _clip_planes(c2)
    inter = 0.5 * torch.abs(_matrix_contrib(c1, n2, an2) + _matrix_contrib(c2, n1, an1).T)
    area1 = torch.abs(boxes1[:, 2] * boxes1[:, 3])
    area2 = torch.abs(boxes2[:, 2] * boxes2[:, 3])
    # physical bound, as JAX's: a coincident edge whose |num| lands just past
    # _EPS can count a duplicate's area twice; the clamp also floors the
    # union at the larger area
    inter = torch.minimum(inter, torch.minimum(area1[:, None], area2[None, :]))
    union = area1[:, None] + area2[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))
