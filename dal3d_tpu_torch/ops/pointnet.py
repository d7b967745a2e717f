"""PointNet++-family point ops (port of ``dal3d_tpu/ops/pointnet.py``):
``knn``, ``three_nn`` / ``three_interpolate``, ``ball_query``,
``gather_points`` / ``group_points`` and ``furthest_point_sample``.

Brute force, as JAX's: the query-to-point distances are one
``distance.pairwise_l2`` call (on a CUDA tensor the K7 kernels: the row
kernel for at most 8 queries, else the 3xTF32 matrix kernel with C = 3
padded to 32; on a CPU tensor its plain Gram-form twin), and every top k is
``nms.top_k``, which orders ties as ``jax.lax.top_k`` does (the lower index
first). Query [M, 3], points [N, 3], features [N, C], f32; indices int64.
"""
from __future__ import annotations

import torch

from . import distance
from .nms import top_k


def knn(query: torch.Tensor, points: torch.Tensor, k: int):
    """query [M, 3], points [N, 3] -> (dists [M, k], idx [M, k]), nearest
    first."""
    d = distance.pairwise_l2(query, points)
    neg, idx = top_k(-d, k)
    return -neg, idx


def three_nn(query: torch.Tensor, points: torch.Tensor):
    """The 3 nearest neighbours (reference pointnet2/src/interpolate.cpp)."""
    return knn(query, points, 3)


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      dists: torch.Tensor) -> torch.Tensor:
    """Inverse-distance-weighted 3-NN feature propagation: features [N, C],
    idx [M, 3], dists [M, 3] -> [M, C]."""
    w = 1.0 / torch.clamp(dists, min=1e-8)
    w = w / w.sum(dim=1, keepdim=True)
    return (features[idx] * w[..., None]).sum(dim=1)


def ball_query(query: torch.Tensor, points: torch.Tensor, radius: float, nsample: int):
    """Indices [M, nsample] of up to ``nsample`` points within ``radius`` of
    each query, in ascending index order, and whether a query has any
    (reference mmdet3d/ops/ball_query). A short group repeats its first hit;
    a query with none gets index 0 throughout and False."""
    d = distance.pairwise_l2(query, points)
    inside = d <= radius
    # inside points ranked by -index (the lowest first), outside ones last
    rank = -torch.arange(points.shape[0], device=points.device, dtype=torch.float32)
    score = torch.where(inside, rank[None, :], torch.full_like(d, float("-inf")))
    _, idx = top_k(score, nsample)
    has = torch.gather(inside, 1, idx)
    return torch.where(has, idx, idx[:, :1]), has.any(dim=1)


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[N, C], [M] -> [M, C]."""
    return points[idx]


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[N, C], [M, S] -> [M, S, C]."""
    return features[idx]


def furthest_point_sample(points: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Iterative farthest point sampling over [N, 3] -> idx [n_samples]
    (reference mmdet3d/ops/furthest_point_sample), JAX's ``lax.scan`` as a
    loop on the points' device: the running minimum of squared differences,
    starting at point 0, the first index among equal maxima; the indices
    stay on the device (no host sync in the loop)."""
    N = points.shape[0]
    min_d = torch.full((N,), float("inf"), dtype=points.dtype, device=points.device)
    idx = torch.zeros(n_samples, dtype=torch.long, device=points.device)
    last = idx[:1]
    for i in range(1, n_samples):
        d = ((points - points.index_select(0, last)) ** 2).sum(dim=-1)
        min_d = torch.minimum(min_d, d)
        last = torch.argmax(min_d).view(1)
        idx[i:i + 1] = last
    return idx
