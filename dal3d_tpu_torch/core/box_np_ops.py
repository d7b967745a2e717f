"""Host-side (numpy) 3D box geometry (own copy of the parts of
``dal3d_tpu/core/box_np_ops.py`` that the train-mode data pipeline needs:
angle wrap, corners and rotations, points-in-box tests; the anchor grid lives
in core/anchors.py and the box coding in core/box_ops.py).

Box convention (lidar frame): [x, y, z, w, l, h, (vx, vy,) yaw], z is the
box *bottom* center in storage, yaw around +z.
"""
from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# angle helpers
# ---------------------------------------------------------------------------

def limit_period(val, offset: float = 0.5, period: float = np.pi):
    return val - np.floor(val / period + offset) * period


# ---------------------------------------------------------------------------
# corners / rotation
# ---------------------------------------------------------------------------

def corners_nd(dims, origin=0.5):
    """Compute corner offsets from box dims. dims: [N, ndim] -> [N, 2**ndim, ndim].

    Corner ordering matches the reference (binary count with x-flip for 2D:
    (x-z)(y-z)(z-z) pattern) so downstream surface/polygon code agrees.
    """
    dims = np.asarray(dims)
    ndim = int(dims.shape[1])
    corners_norm = np.stack(
        np.unravel_index(np.arange(2**ndim), [2] * ndim), axis=1
    ).astype(dims.dtype)
    # reorder to the reference's convention:
    # 2D: [(0,0),(0,1),(1,1),(1,0)]  (counterclockwise when y up)
    # 3D: [(0,0,0),(0,0,1),(0,1,1),(0,1,0),(1,0,0),(1,0,1),(1,1,1),(1,1,0)]
    if ndim == 2:
        corners_norm = corners_norm[[0, 1, 3, 2]]
    elif ndim == 3:
        corners_norm = corners_norm[[0, 1, 3, 2, 4, 5, 7, 6]]
    corners_norm = corners_norm - np.array(origin, dtype=dims.dtype)
    return dims.reshape(-1, 1, ndim) * corners_norm.reshape(1, 2**ndim, ndim)


def rotation_2d(points, angles):
    """Rotate [N, P, 2] points by [N] angles (counterclockwise in reference's
    clockwise-when-y-down convention, matching det3d rotation_2d)."""
    rot_sin = np.sin(angles)
    rot_cos = np.cos(angles)
    rot_mat_T = np.stack([[rot_cos, -rot_sin], [rot_sin, rot_cos]])  # [2,2,N]
    return np.einsum("aij,jka->aik", points, rot_mat_T)


def rotation_3d_in_axis(points, angles, axis=2):
    """Rotate [N, P, 3] points by [N] angles around an axis."""
    rot_sin = np.sin(angles)
    rot_cos = np.cos(angles)
    ones = np.ones_like(rot_cos)
    zeros = np.zeros_like(rot_cos)
    if axis == 1:
        rot_mat_T = np.stack(
            [[rot_cos, zeros, -rot_sin], [zeros, ones, zeros], [rot_sin, zeros, rot_cos]]
        )
    elif axis in (2, -1):
        rot_mat_T = np.stack(
            [[rot_cos, -rot_sin, zeros], [rot_sin, rot_cos, zeros], [zeros, zeros, ones]]
        )
    elif axis == 0:
        rot_mat_T = np.stack(
            [[ones, zeros, zeros], [zeros, rot_cos, -rot_sin], [zeros, rot_sin, rot_cos]]
        )
    else:
        raise ValueError("axis should be in [0, 1, 2]")
    return np.einsum("aij,jka->aik", points, rot_mat_T)


def center_to_corner_box2d(centers, dims, angles=None, origin=0.5):
    """BEV boxes -> corners. centers [N,2], dims [N,2], angles [N] -> [N,4,2]."""
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_2d(corners, angles)
    return corners + centers.reshape(-1, 1, 2)


def center_to_corner_box3d(centers, dims, angles=None, origin=(0.5, 0.5, 0.0), axis=2):
    """3D boxes -> 8 corners. origin (0.5,0.5,0) = z is bottom center."""
    corners = corners_nd(dims, origin=origin)
    if angles is not None:
        corners = rotation_3d_in_axis(corners, angles, axis=axis)
    return corners + centers.reshape(-1, 1, 3)


def corner_to_standup_nd(boxes_corner):
    """[N, K, ndim] corners -> [N, 2*ndim] axis-aligned (min..., max...)."""
    return np.concatenate([boxes_corner.min(axis=1), boxes_corner.max(axis=1)], axis=-1)








# ---------------------------------------------------------------------------
# points-in-box tests (for GT database creation / point aug)
# ---------------------------------------------------------------------------

def corner_to_surfaces_3d(corners):
    """[N, 8, 3] corners -> [N, 6, 4, 3] surfaces with outward normals."""
    surfaces = np.array(
        [
            [corners[:, 0], corners[:, 1], corners[:, 2], corners[:, 3]],
            [corners[:, 7], corners[:, 6], corners[:, 5], corners[:, 4]],
            [corners[:, 0], corners[:, 3], corners[:, 7], corners[:, 4]],
            [corners[:, 1], corners[:, 5], corners[:, 6], corners[:, 2]],
            [corners[:, 0], corners[:, 4], corners[:, 5], corners[:, 1]],
            [corners[:, 3], corners[:, 2], corners[:, 6], corners[:, 7]],
        ]
    ).transpose([2, 0, 1, 3])
    return surfaces


def surface_equ_3d(polygon_surfaces):
    """Plane (normal, d) per surface from its first 3 vertices."""
    surface_vec = polygon_surfaces[:, :, :2, :] - polygon_surfaces[:, :, 1:3, :]
    normal_vec = np.cross(surface_vec[:, :, 0, :], surface_vec[:, :, 1, :])
    d = -np.einsum("aij,aij->ai", normal_vec, polygon_surfaces[:, :, 0, :])
    return normal_vec, d


def points_in_convex_polygon_3d(points, polygon_surfaces):
    """points [P,3], polygon_surfaces [N,6,4,3] -> bool [P,N]."""
    normal_vec, d = surface_equ_3d(polygon_surfaces)
    # sign = p . n + d ; inside if <= 0 for all surfaces
    sign = np.einsum("pk,nsk->pns", points[:, :3], normal_vec) + d[None, :, :]
    return np.all(sign < 0, axis=-1)


def points_in_rbbox(points, rbbox, origin=(0.5, 0.5, 0.0)):
    """points [P, >=3], rbbox [N, 7] -> bool [P, N]."""
    rbbox = np.asarray(rbbox)
    if rbbox.shape[0] == 0:
        return np.zeros((points.shape[0], 0), dtype=bool)
    # boxes may carry velocity dims; geometry uses x,y,z,w,l,h,yaw
    if rbbox.shape[-1] > 7:
        rbbox = rbbox[:, [0, 1, 2, 3, 4, 5, rbbox.shape[-1] - 1]]
    rbbox_corners = center_to_corner_box3d(
        rbbox[:, :3], rbbox[:, 3:6], rbbox[:, 6], origin=origin, axis=2
    )
    surfaces = corner_to_surfaces_3d(rbbox_corners)
    return points_in_convex_polygon_3d(points[:, :3], surfaces)
