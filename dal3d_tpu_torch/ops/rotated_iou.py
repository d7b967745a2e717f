"""Rotated BEV and 3D box IoU by convex polygon clipping (port of
``dal3d_tpu/ops/rotated_iou.py``): the intersection of two rotated
rectangles by Sutherland-Hodgman clipping with a fixed vertex buffer,
batched over every pair, in plain PyTorch on the input tensor's device.

This is the evaluation's IoU, not the NMS's: the NMS uses the Green's-form
IoU of ``ops/iou_matrix.py`` (the port of the Pallas kernel), a different
function of the JAX package. The two agree on non-degenerate boxes within
float rounding.

Where the port rounds differently from JAX: each pair is clipped in a frame
centred on its first box (``_pairwise_intersection``), and the shoelace
sums run left to right on every device (``_sum_in_order``); the clip itself
(buffer, emit order, the division guard, the dropped positions) is JAX's.

Boxes are BEV [x, y, w, l, yaw] with the corner convention of
``core.box_ops.corners_2d``.
"""
from __future__ import annotations

import torch

from ..core.box_ops import corners_2d

_VBUF = 16  # the intersection of two convex quads has <= 8 vertices; headroom for clipping


def _clip_halfplane(poly, count, a, b):
    """Clip polygons ``poly`` [P, V, 2] (``count`` [P] valid vertices each)
    by the half-plane left of the edge a -> b (a, b [P, 2]).

    Emits, per input edge (cur -> nxt): cur if inside, then the edge /
    half-plane intersection if the edge crosses. Returns (new_poly [P, V, 2],
    new_count [P]). Positions past the buffer are dropped, as JAX's
    ``.at[pos].set(mode="drop")`` does, through a dump row V that is sliced
    off."""
    P, V = poly.shape[0], poly.shape[1]
    idx = torch.arange(V, device=poly.device)
    cnt = count[:, None]
    in_poly = idx[None, :] < cnt
    nxt_idx = torch.where(idx[None, :] + 1 < cnt, idx[None, :] + 1, torch.zeros_like(cnt))
    cur = poly
    nxt = torch.gather(poly, 1, nxt_idx[..., None].expand(P, V, 2))

    edge = b - a
    ax, ay = a[:, 0:1], a[:, 1:2]
    ex, ey = edge[:, 0:1], edge[:, 1:2]
    # signed area; inside = left of a -> b
    side_cur = ex * (cur[..., 1] - ay) - ey * (cur[..., 0] - ax)
    side_nxt = ex * (nxt[..., 1] - ay) - ey * (nxt[..., 0] - ax)
    in_cur = side_cur >= 0
    in_nxt = side_nxt >= 0

    denom = side_cur - side_nxt
    one = torch.ones((), dtype=denom.dtype, device=denom.device)
    zero = torch.zeros((), dtype=denom.dtype, device=denom.device)
    t = torch.where(torch.abs(denom) > 1e-12,
                    side_cur / torch.where(denom == 0, one, denom), zero)
    inter = cur + t[..., None] * (nxt - cur)

    emit_cur = in_cur & in_poly
    emit_int = (in_cur != in_nxt) & in_poly

    # positions via an exclusive cumsum of the emit counts
    ec, ei = emit_cur.to(torch.int64), emit_int.to(torch.int64)
    n_emit = ec + ei
    base = torch.cumsum(n_emit, dim=1) - n_emit
    pos_cur = torch.clamp(torch.where(emit_cur, base, V), max=V)
    pos_int = torch.clamp(torch.where(emit_int, base + ec, V), max=V)

    out = torch.zeros((P, V + 1, 2), dtype=poly.dtype, device=poly.device)
    out.scatter_(1, pos_cur[..., None].expand(P, V, 2), cur)
    out.scatter_(1, pos_int[..., None].expand(P, V, 2), inter)
    return out[:, :V], n_emit.sum(1)


def _poly_area(poly, count):
    P, V = poly.shape[0], poly.shape[1]
    idx = torch.arange(V, device=poly.device)
    cnt = count[:, None]
    nxt_idx = torch.where(idx[None, :] + 1 < cnt, idx[None, :] + 1, torch.zeros_like(cnt))
    nxt = torch.gather(poly, 1, nxt_idx[..., None].expand(P, V, 2))
    cross = poly[..., 0] * nxt[..., 1] - nxt[..., 0] * poly[..., 1]
    cross = torch.where(idx[None, :] < cnt, cross, torch.zeros_like(cross))
    return torch.abs(0.5 * _sum_in_order(cross))


def _sum_in_order(x):
    """Sum over the last dim, left to right: the same order on every device
    (a reduction kernel's order is the device's), so that the card and the
    CPU round the shoelace sum alike."""
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def _ccw(c):
    """Corners [P, 4, 2] in counterclockwise winding (shoelace > 0)."""
    a2 = _sum_in_order(c[..., 0] * torch.roll(c[..., 1], -1, dims=-1)
                       - torch.roll(c[..., 0], -1, dims=-1) * c[..., 1])
    return torch.where((a2 < 0)[:, None, None], torch.flip(c, dims=[-2]), c)


def _rect_intersection_area(c1, c2):
    """c1, c2: [P, 4, 2] corner arrays (convex, consistent winding) ->
    intersection areas [P]."""
    c1, c2 = _ccw(c1), _ccw(c2)
    P = c1.shape[0]
    poly = torch.zeros((P, _VBUF, 2), dtype=c1.dtype, device=c1.device)
    poly[:, :4] = c1
    count = torch.full((P,), 4, dtype=torch.int64, device=c1.device)
    for i in range(4):
        poly, count = _clip_halfplane(poly, count, c2[:, i], c2[:, (i + 1) % 4])
    area = _poly_area(poly, count)
    return torch.where(count >= 3, area, torch.zeros_like(area))


def _pairwise_intersection(bev1, bev2):
    """BEV boxes [N, 5] x [M, 5] -> intersection areas [N, M].

    Each pair is clipped in a frame centred on its first box: the corners
    are the boxes' own (centred) corners, the second shifted by the centres'
    difference. The area is the same function as JAX's clip of absolute
    corners, but its f32 sums no longer round terms of |x|^2 (at 50 m from
    the origin a corner's last bit moves JAX's IoU by ~1e-4), so the card
    and the CPU, whose sin / cos differ in the last bit, agree."""
    N, M = bev1.shape[0], bev2.shape[0]
    c1 = corners_2d(torch.cat([torch.zeros_like(bev1[:, :2]), bev1[:, 2:5]], 1))  # [N, 4, 2]
    c2 = corners_2d(torch.cat([torch.zeros_like(bev2[:, :2]), bev2[:, 2:5]], 1))  # [M, 4, 2]
    shift = bev2[None, :, :2] - bev1[:, None, :2]  # [N, M, 2]
    a = c1[:, None].expand(N, M, 4, 2).reshape(N * M, 4, 2)
    b = (c2[None] + shift[:, :, None, :]).reshape(N * M, 4, 2)
    return _rect_intersection_area(a, b).reshape(N, M)


def rotated_iou_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor,
                       block: int = 128) -> torch.Tensor:
    """Exact rotated IoU matrix [N, M] for BEV boxes [*, 5] (x, y, w, l, yaw),
    on the inputs' device. Rows go in blocks of ``block``, so peak memory
    stays at block * M clip buffers; a pair's value does not depend on the
    block it falls in."""
    N, M = boxes1.shape[0], boxes2.shape[0]
    area1 = boxes1[:, 2] * boxes1[:, 3]
    area2 = boxes2[:, 2] * boxes2[:, 3]
    out = []
    for s in range(0, N, block):
        ab = area1[s:s + block]
        inter = _pairwise_intersection(boxes1[s:s + block], boxes2)
        union = ab[:, None] + area2[None, :] - inter
        out.append(torch.where(union > 0, inter / union, torch.zeros_like(inter)))
    if not out:
        return torch.zeros((0, M), dtype=boxes1.dtype, device=boxes1.device)
    return torch.cat(out, 0)


def boxes_iou3d(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Exact 3D rotated IoU matrix [N, M] for boxes [*, 7+] (x, y, z, w, l,
    h, ..., yaw), z = bottom center: BEV polygon intersection x z-overlap."""
    def bev(b):
        return torch.stack([b[:, 0], b[:, 1], b[:, 3], b[:, 4], b[:, -1]], -1)

    bev1, bev2 = bev(boxes1), bev(boxes2)
    area1 = bev1[:, 2] * bev1[:, 3]
    area2 = bev2[:, 2] * bev2[:, 3]
    inter_bev = _pairwise_intersection(bev1, bev2)  # [N, M]
    z1lo, z1hi = boxes1[:, 2], boxes1[:, 2] + boxes1[:, 5]
    z2lo, z2hi = boxes2[:, 2], boxes2[:, 2] + boxes2[:, 5]
    zov = torch.clamp(torch.minimum(z1hi[:, None], z2hi[None, :])
                      - torch.maximum(z1lo[:, None], z2lo[None, :]), min=0.0)
    inter3d = inter_bev * zov
    vol1 = area1 * boxes1[:, 5]
    vol2 = area2 * boxes2[:, 5]
    union = vol1[:, None] + vol2[None, :] - inter3d
    return torch.where(union > 0, inter3d / union, torch.zeros_like(inter3d))
