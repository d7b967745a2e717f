"""Host (numpy) mean voxelizer of the pool's data path.

Same contract as the JAX package's native ``host_ops.points_to_voxel_mean``
(and the numba voxelizer of the reference behind it): voxels in
first-appearance order, at most ``max_voxels`` of them (points of later
voxels are dropped), the mean of each voxel's first ``max_points`` points,
(z, y, x) coordinates. Cell indices are computed in f32 with the same
divide expression, so they agree bit for bit; the means are summed in f64
here (f32 there) and agree within f32 rounding.
"""
from __future__ import annotations

import numpy as np
import torch


def points_to_voxel_mean(points, voxel_size, point_cloud_range, max_points: int,
                         max_voxels: int, bf16: bool = False):
    """points [P, F] f32 -> (mean features [n, F], coords [n, 3] int32
    (z, y, x), points per voxel [n] int32) with n kept voxels.

    ``bf16=True`` returns the means as a ``torch.bfloat16`` tensor (rounded
    to nearest even from the f32 mean; numpy has no bf16), else a float32
    numpy array."""
    points = np.ascontiguousarray(points, np.float32)
    vs = np.asarray(voxel_size, np.float32)
    pcr = np.asarray(point_cloud_range, np.float32)
    grid = np.round((pcr[3:] - pcr[:3]) / vs).astype(np.int64)
    F = points.shape[1]
    c = np.floor((points[:, :3] - pcr[:3]) / vs).astype(np.int64)
    ok = np.all((c >= 0) & (c < grid), axis=1)
    pts, c = points[ok], c[ok]
    lin = (c[:, 2] * grid[1] + c[:, 1]) * grid[0] + c[:, 0]
    _, first, inv = np.unique(lin, return_index=True, return_inverse=True)
    by_first = np.argsort(first)
    rank = np.empty(len(first), np.int64)
    rank[by_first] = np.arange(len(first))
    vid = rank[inv.reshape(-1)]  # voxel id of each point, in first-appearance order
    n = min(len(first), int(max_voxels))
    # position of each point among its voxel's points, in input order
    order = np.argsort(vid, kind="stable")
    starts = np.searchsorted(vid[order], np.arange(len(first)))
    slot = np.empty(len(vid), np.int64)
    slot[order] = np.arange(len(vid)) - starts[vid[order]]
    take = (slot < max_points) & (vid < n)
    v = vid[take]
    cnt = np.bincount(v, minlength=n).astype(np.int32)
    inv_cnt = np.float32(1.0) / np.maximum(cnt, 1).astype(np.float32)
    mean = np.empty((n, F), np.float32)
    for f in range(F):
        mean[:, f] = np.bincount(v, weights=pts[take, f], minlength=n).astype(np.float32) * inv_cnt
    coords = c[first[by_first[:n]]][:, ::-1].astype(np.int32)
    if bf16:
        return torch.from_numpy(mean).to(torch.bfloat16), coords, cnt
    return mean, coords, cnt
