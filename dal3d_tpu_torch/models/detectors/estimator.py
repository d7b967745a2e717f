"""Box-quality estimators of the partial-label AL pipeline (port of
``dal3d_tpu/models/detectors/estimator.py``: ``points_in_box_pool``,
``Estimator``, ``PPEstimator``).

A second network predicts the quality (3D IoU against the labels) of a
detector's boxes from the raw points around each box: a fixed-shape pool of
each box's interior points in the box frame, a PointNet-style MLP with a
max-pool, and the box geometry.

Weights: ``nn.Linear`` layers ``point_mlp.<i>`` (the hidden widths), ``fc``
(128) and ``out`` (1), which are flax's ``Dense_0 ... Dense_{n+1}`` in that
order (``models/convert_flax.py::estimator_flax_to_state_dict`` carries
them both ways).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn


def pool_order(inside: torch.Tensor, max_pts: int) -> torch.Tensor:
    """[K, P] interior mask -> the indices [K, max_pts] of the first
    ``max_pts`` points in this order: interior points by ascending index,
    then the others by ascending index.

    JAX ranks ``inside - index * 1e-9`` with ``lax.top_k``, whose ties (f32
    collapses neighbouring indices) go to the lower index: the order above.
    Here each point gets the distinct integer key ``inside * P + (P - 1 -
    index)``, so ``topk`` has no ties to break and gives that order on every
    device."""
    P = inside.shape[-1]
    rank = torch.arange(P - 1, -1, -1, device=inside.device, dtype=torch.int32)
    return torch.topk(inside.to(torch.int32) * P + rank, max_pts, dim=-1).indices


def _box_frame(points: torch.Tensor, points_valid: torch.Tensor, boxes: torch.Tensor,
               expand: float):
    """Each point [P, F] in each box's frame [K, 9]: (lx, ly, lz [K, P], z
    above the bottom face; inside [K, P])."""
    rel = points[None, :, :2] - boxes[:, None, :2]  # [K, P, 2]
    cos, sin = torch.cos(boxes[:, -1]), torch.sin(boxes[:, -1])
    lx = rel[..., 0] * cos[:, None] + rel[..., 1] * sin[:, None]
    ly = -rel[..., 0] * sin[:, None] + rel[..., 1] * cos[:, None]
    lz = points[None, :, 2] - boxes[:, None, 2]
    inside = ((torch.abs(lx) <= boxes[:, None, 3] * expand / 2)
              & (torch.abs(ly) <= boxes[:, None, 4] * expand / 2)
              & (lz >= 0) & (lz <= boxes[:, None, 5] * expand)
              & points_valid[None, :])
    return lx, ly, lz, inside


def pool_index(points: torch.Tensor, points_valid: torch.Tensor, boxes: torch.Tensor,
               max_pts: int = 128, expand: float = 1.0):
    """The points ``points_in_box_pool`` takes for each box: (indices [K,
    max_pts] into the cloud, mask [K, max_pts]: the point is inside)."""
    inside = _box_frame(points, points_valid, boxes, expand)[3]
    idx = pool_order(inside, max_pts)
    return idx, torch.gather(inside, 1, idx)


def points_in_box_pool(points: torch.Tensor, points_valid: torch.Tensor, boxes: torch.Tensor,
                       max_pts: int = 128, expand: float = 1.0):
    """For each box [K, 9], the points of the cloud [P, F] that
    ``pool_order`` picks. Returns (features [K, max_pts, 4]: x, y, z in the
    box frame (z above the bottom face) and the intensity, zero where masked;
    mask [K, max_pts]: the point is inside the box)."""
    lx, ly, lz, inside = _box_frame(points, points_valid, boxes, expand)
    idx = pool_order(inside, max_pts)
    mask = torch.gather(inside, 1, idx)
    inten = points[idx, 3] if points.shape[1] > 3 else torch.zeros_like(idx, dtype=points.dtype)
    feat = torch.stack([torch.gather(lx, 1, idx), torch.gather(ly, 1, idx),
                        torch.gather(lz, 1, idx), inten], dim=-1)
    return torch.where(mask[..., None], feat, torch.zeros((), dtype=feat.dtype,
                                                          device=feat.device)), mask


class Estimator(nn.Module):
    """Box-quality (IoU) estimator: pooled box points + box geometry -> IoU
    in [0, 1]."""

    def __init__(self, max_pts: int = 128, hidden: Sequence[int] = (64, 128)):
        super().__init__()
        self.max_pts = int(max_pts)
        self.hidden = tuple(int(h) for h in hidden)
        widths = (4,) + self.hidden
        self.point_mlp = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths, widths[1:]))
        self.fc = nn.Linear(self.hidden[-1] + 5, 128)
        self.out = nn.Linear(128, 1)

    def pool(self, points: torch.Tensor, points_valid: torch.Tensor, boxes: torch.Tensor):
        """points [B, P, F], points_valid [B, P], boxes [B, K, 9] ->
        (features [B, K, max_pts, 4], mask [B, K, max_pts]), one sample at a
        time (the [K, P] planes of one sample are freed before the next)."""
        pooled = [points_in_box_pool(points[b], points_valid[b], boxes[b], self.max_pts)
                  for b in range(points.shape[0])]
        return torch.stack([f for f, _ in pooled]), torch.stack([m for _, m in pooled])

    def head(self, feat: torch.Tensor, mask: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """The network on pooled features -> IoU [B, K]. A box without an
        interior point max-pools the fill value -1e9, which is finite and
        goes on into ``fc`` (JAX's behaviour, kept)."""
        x = feat
        for lin in self.point_mlp:
            x = torch.relu(lin(x))
        x = torch.where(mask[..., None], x, torch.full((), -1e9, dtype=x.dtype,
                                                       device=x.device)).max(dim=2).values
        x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
        geom = torch.cat([boxes[..., 3:6], torch.cos(boxes[..., -1:]),
                          torch.sin(boxes[..., -1:])], -1)
        x = torch.relu(self.fc(torch.cat([x, geom], dim=-1)))
        return torch.sigmoid(self.out(x)[..., 0])

    def forward(self, points: torch.Tensor, points_valid: torch.Tensor,
                boxes: torch.Tensor) -> torch.Tensor:
        """points [B, P, F], points_valid [B, P], boxes [B, K, 9] ->
        predicted IoU [B, K] in [0, 1]."""
        feat, mask = self.pool(points, points_valid, boxes)
        return self.head(feat, mask, boxes)


class PPEstimator(Estimator):
    """PointPillars-flavoured estimator: the same contract, shallower
    pooling."""

    def __init__(self, max_pts: int = 64, hidden: Sequence[int] = (64,)):
        super().__init__(max_pts, hidden)


def init_estimator_(est: Estimator, generator: torch.Generator) -> Estimator:
    """flax ``Dense``'s default initialisation drawn from ``generator`` on the
    CPU: kernels truncated normal (+-2 sigma) with variance 1 / fan_in
    (lecun_normal), biases zero."""
    with torch.no_grad():
        for m in est.modules():
            if isinstance(m, nn.Linear):
                std = float(np.sqrt(1.0 / m.weight.shape[1])) / 0.87962566103423978
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
                m.weight.copy_(w)
                m.bias.zero_()
    return est
