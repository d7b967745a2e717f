"""BEV polygon collision test (the part of ``dal3d_tpu/data/sampler.py`` that
the per-object noise augmentation needs). The GT-AUG database sampler
(``DataBaseSamplerV2``) itself is not ported yet.
"""
from __future__ import annotations

import numpy as np

from ..core import box_np_ops


def _segments_intersect(a0, a1, b0, b1):
    """Vectorized proper segment intersection. a*: [..., 2], b*: [..., 2]."""

    def cross(o, p, q):
        return (p[..., 0] - o[..., 0]) * (q[..., 1] - o[..., 1]) - (
            p[..., 1] - o[..., 1]
        ) * (q[..., 0] - o[..., 0])

    d1 = cross(b0, b1, a0)
    d2 = cross(b0, b1, a1)
    d3 = cross(a0, a1, b0)
    d4 = cross(a0, a1, b1)
    return ((d1 * d2) < 0) & ((d3 * d4) < 0)


def _point_in_quad(pts, quad):
    """pts [..., 2], quad [..., 4, 2] convex -> bool[...] via sign-consistency."""
    s = []
    for i in range(4):
        a = quad[..., i, :]
        b = quad[..., (i + 1) % 4, :]
        s.append(
            (b[..., 0] - a[..., 0]) * (pts[..., 1] - a[..., 1])
            - (b[..., 1] - a[..., 1]) * (pts[..., 0] - a[..., 0])
        )
    s = np.stack(s, -1)
    return np.all(s >= 0, -1) | np.all(s <= 0, -1)


def box_collision_test(boxes_corners: np.ndarray, qboxes_corners: np.ndarray) -> np.ndarray:
    """[N,4,2] vs [K,4,2] -> bool [N,K] BEV polygon overlap."""
    N, K = boxes_corners.shape[0], qboxes_corners.shape[0]
    if N == 0 or K == 0:
        return np.zeros((N, K), bool)
    # standup prefilter
    a_st = box_np_ops.corner_to_standup_nd(boxes_corners)
    b_st = box_np_ops.corner_to_standup_nd(qboxes_corners)
    iw = np.minimum(a_st[:, None, 2], b_st[None, :, 2]) - np.maximum(a_st[:, None, 0], b_st[None, :, 0])
    ih = np.minimum(a_st[:, None, 3], b_st[None, :, 3]) - np.maximum(a_st[:, None, 1], b_st[None, :, 1])
    cand = (iw > 0) & (ih > 0)

    # vertex containment both ways
    inside_ab = _point_in_quad(
        boxes_corners[:, None, :, :], qboxes_corners[None, :, None, :, :]
    ).any(-1)
    inside_ba = _point_in_quad(
        qboxes_corners[None, :, :, :], boxes_corners[:, None, None, :, :]
    ).any(-1)

    # edge intersection: [N,K,4,4]
    a0 = boxes_corners[:, None, :, None, :]
    a1 = np.roll(boxes_corners, -1, axis=1)[:, None, :, None, :]
    b0 = qboxes_corners[None, :, None, :, :]
    b1 = np.roll(qboxes_corners, -1, axis=1)[None, :, None, :, :]
    edges = _segments_intersect(a0, a1, b0, b1).any((-1, -2))

    return cand & (inside_ab | inside_ba | edges)
