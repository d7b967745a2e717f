"""Rotated BEV IoU matrices for the batched NMS (port of
``dal3d_tpu/ops/pallas_iou.py``).

Per box set a 32-float record is packed once (``_pack_rowdat``: corners,
edge vectors, inward clip planes, area); the kernel
(``csrc/iou_matrix.cu``) then computes every pair's Green's-theorem
intersection from two records. The plain version below repeats the kernel's
arithmetic broadcast over [G, N, M].

The kernel skips the clip of a pair whose plain value is exactly +0.0 by
construction (boxes whose circumscribed discs lie apart by a margin, or a
box of zero area) and writes +0.0 there. ``iou_cull_plain`` is the plain
twin of that predicate, for the tests and ``chip_smoke.py``; the tests show
on the CPU that the plain version gives +0.0 on every pair it culls.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.box_ops import corners_2d
from . import _build

_EPS = 1e-4  # meters; identical to the JAX kernel
_REC = 32  # record floats (29 used)
# the cull (csrc/iou_matrix.cu, kCullMargin / kCullRel): two boxes are apart
# when their centres lie farther apart than the sum of their reaches plus
# this margin (meters); a reach is the circumradius plus this share of
# |cx| + |cy| + r, for the rounding of coordinates far from the origin
_CULL_MARGIN = 1e-2
_CULL_REL = 1e-5
_F32_MAX = float(torch.finfo(torch.float32).max)


def _pack_rowdat(boxes: torch.Tensor) -> torch.Tensor:
    """BEV boxes [G, N, 5] (x, y, w, l, yaw) -> records [G, N, 32] f32.

    Lanes: 0-3 p0x(e), 4-7 p0y(e), 8-11 dx(e), 12-15 dy(e),
           16-19 nx(p), 20-23 ny(p), 24-27 an(p), 28 area, 29-31 zero."""
    boxes = boxes.float()
    c = corners_2d(boxes)  # [G, N, 4, 2]
    d = torch.roll(c, -1, dims=-2) - c
    elen = torch.sqrt(torch.clamp((d * d).sum(-1), min=1e-20))
    n = torch.stack([d[..., 1], -d[..., 0]], dim=-1) / elen[..., None]
    an = (n * c).sum(-1)
    area = torch.abs(boxes[..., 2] * boxes[..., 3])[..., None]
    rec = torch.cat([c[..., 0], c[..., 1], d[..., 0], d[..., 1], n[..., 0],
                     n[..., 1], an, area], dim=-1)  # [G, N, 29]
    return torch.nn.functional.pad(rec, (0, _REC - rec.shape[-1])).contiguous()


def _clip_dir_plain(E, P):
    """One clip direction, broadcast: E [..., 32] edge records, P [..., 32]
    plane records (broadcastable against each other)."""
    zero = torch.zeros((), device=E.device)
    false = torch.zeros((), dtype=torch.bool, device=E.device)
    contrib = zero
    for e in range(4):
        p0x, p0y, dx, dy = E[..., e], E[..., 4 + e], E[..., 8 + e], E[..., 12 + e]
        t_lo, t_hi, on_b, killed = zero, zero + 1.0, false, false
        for p in range(4):
            nx, ny, an = P[..., 16 + p], P[..., 20 + p], P[..., 24 + p]
            num = p0x * nx + p0y * ny - an
            den = dx * nx + dy * ny
            par = torch.abs(den) < _EPS
            t_at = -num / torch.where(par, 1.0, den)
            entry = den > 0
            t_lo = torch.maximum(t_lo, torch.where(entry & ~par, t_at, 0.0))
            t_hi = torch.minimum(t_hi, torch.where(~entry & ~par, t_at, 1.0))
            on_b = on_b | (par & (torch.abs(num) <= _EPS))
            killed = killed | (par & (num < -_EPS))
        weight = torch.where(on_b, 0.5, 1.0)
        t_lo = torch.clamp(t_lo, 0.0, 1.0)
        t_hi = torch.clamp(t_hi, 0.0, 1.0)
        ok = (t_hi > t_lo) & ~killed
        ux = p0x + t_lo * dx
        uy = p0y + t_lo * dy
        vx = p0x + t_hi * dx
        vy = p0y + t_hi * dy
        cr = ux * vy - vx * uy
        contrib = contrib + torch.where(ok, cr, 0.0) * weight
    return contrib


def iou_matrix_plain(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: records [G, N, 32] x [G, M, 32]
    -> IoU [G, N, M] f32."""
    r = rows[:, :, None, :]  # boxes i vary over dim 1
    c = cols[:, None, :, :]  # boxes j vary over dim 2
    t1 = _clip_dir_plain(r, c)
    t2 = _clip_dir_plain(c, r)
    inter = 0.5 * torch.abs(t1 + t2)
    ai, aj = r[..., 28], c[..., 28]
    inter = torch.minimum(inter, torch.minimum(ai, aj))
    union = ai + aj - inter
    return torch.where(union > 0, inter / union, 0.0)


def cull_keys_plain(rec: torch.Tensor) -> tuple:
    """Per record [..., 32]: (cx, cy, reach, zero_area), in the kernel's
    order of operations. The centre is the mean of the corners (lanes 0-7),
    the reach the circumradius about it widened by _CULL_REL; a record with
    a lane 0-28 that is not finite gets a NaN reach, which no cull passes.
    zero_area: lane 28 is +0.0."""
    x, y = rec[..., 0:4], rec[..., 4:8]
    cx = ((x[..., 0] + x[..., 1]) + (x[..., 2] + x[..., 3])) * 0.25
    cy = ((y[..., 0] + y[..., 1]) + (y[..., 2] + y[..., 3])) * 0.25
    ex, ey = x - cx[..., None], y - cy[..., None]
    r = torch.sqrt((ex * ex + ey * ey).amax(-1))
    nonfinite = (rec[..., :29] * 0.0).sum(-1)  # 0, or NaN if a lane is inf or NaN
    reach = r + _CULL_REL * ((cx.abs() + cy.abs()) + r) + nonfinite
    zero_area = rec[..., 28].view(torch.int32) == 0
    return cx, cy, reach, zero_area


def iou_cull_plain(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Plain twin of the kernel's cull: records [G, N, 32] x [G, M, 32] ->
    bool [G, N, M], True where the kernel writes +0.0 without the clip.
    Every comparison fails on NaN, and a distance or reach that overflows
    fails too, so such pairs go through the clip."""
    cxi, cyi, ri, zi = (k[:, :, None] for k in cull_keys_plain(rows))
    cxj, cyj, rj, zj = (k[:, None, :] for k in cull_keys_plain(cols))
    dx, dy = cxi - cxj, cyi - cyj
    d2 = dx * dx + dy * dy
    s = (ri + rj) + _CULL_MARGIN
    apart = (d2 > s * s) & (d2 <= _F32_MAX)
    empty = (zi | zj) & ((ri + rj) <= _F32_MAX)
    return apart | empty


def iou_matrix(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The kernel's wrapper: records [G, N, 32] x [G, M, 32] f32 -> [G, N, M].

    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/iou_matrix.cu`` or raise. ``iou_matrix.launches`` counts launches."""
    if rows.device.type == "cpu":
        return iou_matrix_plain(rows, cols)
    if rows.device.type != "cuda":
        raise ValueError(f"iou_matrix: unsupported device {rows.device}")
    G, N, K = rows.shape
    if (rows.dtype != torch.float32 or cols.dtype != torch.float32 or K != _REC
            or cols.shape[0] != G or cols.shape[2] != _REC):
        raise ValueError(f"iou_matrix: records must be f32 [G, N, {_REC}], got "
                         f"{tuple(rows.shape)} {rows.dtype} / {tuple(cols.shape)} {cols.dtype}")
    if cols.device != rows.device or not (rows.is_contiguous() and cols.is_contiguous()):
        raise ValueError("iou_matrix: records must be contiguous on one device")
    M = cols.shape[1]
    # one record set against itself (the NMS): the kernel mirrors its pairs
    same = rows.data_ptr() == cols.data_ptr() and N == M
    out = torch.empty(G, N, M, dtype=torch.float32, device=rows.device)
    _build.function("iou_matrix", "iou_matrix_f32", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4,
                    "iou_matrix")(rows.device, rows.data_ptr(), cols.data_ptr(), out.data_ptr(),
                                  G, N, M, int(same))
    iou_matrix.launches += 1
    return out


iou_matrix.launches = 0


def rotated_iou_matrix_batched(boxes1: torch.Tensor,
                               boxes2: torch.Tensor) -> torch.Tensor:
    """[G, N, 5] x [G, M, 5] BEV boxes (x, y, w, l, yaw) -> IoU [G, N, M]."""
    rows = _pack_rowdat(boxes1)
    cols = rows if boxes2 is boxes1 else _pack_rowdat(boxes2)
    return iou_matrix(rows, cols)
