"""PointPillars' pillar encoder and BEV scatter (port of
``dal3d_tpu/models/readers/pillar_encoder.py``; the reference's
det3d/models/readers/pillar_encoder.py:61-200).

JAX's design is kept: no ragged [M, K, F] pillar tensor and no sort. Each
point is decorated with its offset from its pillar's mean and from the
pillar's centre (a segment mean by ``scatter_add_``), the PFN's linear +
masked BN + ReLU runs per point, and the pillar feature is the per-pillar
max (``scatter_reduce(..., "amax")``). That is the reference's masked max
over a pillar's points when no per-pillar point cap binds. Everything runs
batched over the clouds ([B, P, F]); JAX vmaps one cloud at a time.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ...ops.voxelize import VoxelConfig
from ..layers import MaskedBatchNorm

_NEG = -1e9  # JAX's empty-pillar fill of the scatter-max


def pillarize(points: torch.Tensor, valid: torch.Tensor, cfg: VoxelConfig):
    """Sort-free point -> pillar assignment, z collapsed: points [B, P, F],
    valid [B, P] -> (point_ok [B, P], pillar_of_point [B, P] int32 (M for a
    point without a pillar), pillar_coords [B, M, 3] int32 (0, y, x),
    pillar_valid [B, M]) with M = ``cfg.max_voxel_num`` pillars a cloud in
    ascending cell order, the first M occupied cells kept. The cells are
    floor((xy - range_min) / voxel_size) in the points' dtype, as JAX's; the
    grid test runs on the floored values (JAX's saturated int32 cast)."""
    M = cfg.max_voxel_num
    nx, ny, _ = cfg.grid_size
    cells = nx * ny
    B = points.shape[0]
    r0 = torch.tensor(cfg.point_cloud_range[:3], dtype=points.dtype, device=points.device)
    vs = torch.tensor(cfg.voxel_size, dtype=points.dtype, device=points.device)
    fx = torch.floor((points[..., 0] - r0[0]) / vs[0])
    fy = torch.floor((points[..., 1] - r0[1]) / vs[1])
    zmin, zmax = cfg.point_cloud_range[2], cfg.point_cloud_range[5]
    ok = (valid & (fx >= 0) & (fx < nx) & (fy >= 0) & (fy < ny)
          & (points[..., 2] >= zmin) & (points[..., 2] < zmax)
          & torch.isfinite(points[..., :3]).all(-1))
    zero = torch.zeros((), dtype=points.dtype, device=points.device)
    cx = torch.where(ok, fx, zero).long()
    cy = torch.where(ok, fy, zero).long()
    lin = torch.where(ok, cy * nx + cx, torch.full_like(cx, cells))
    occ = torch.zeros(B, cells + 1, dtype=torch.bool, device=points.device)
    occ.scatter_(1, lin, True)
    occ[:, cells] = False
    rank = torch.cumsum(occ.int(), dim=1) - 1  # ascending cells: the pillar's index
    keep = occ & (rank < M)
    pillar_of_cell = torch.where(keep, rank, torch.full_like(rank, M))
    cell_list = torch.full((B, M + 1), cells, dtype=torch.long, device=points.device)
    cell_ids = torch.arange(cells + 1, device=points.device).expand(B, -1)
    cell_list.scatter_(1, torch.where(keep, rank, torch.full_like(rank, M)).long(),
                       torch.where(keep, cell_ids, torch.full_like(cell_ids, cells)))
    cell_list = cell_list[:, :M]
    pid = torch.gather(pillar_of_cell, 1, lin).int()
    coords = torch.stack([torch.zeros_like(cell_list), cell_list // nx, cell_list % nx],
                         dim=-1).int()
    return ok & (pid < M), pid, coords, cell_list < cells


class PillarFeatureNet(nn.Module):
    """Per-point decoration + PFN layers + per-pillar max."""

    def __init__(self, num_input_features: int = 4, num_filters: Sequence[int] = (64,),
                 with_distance: bool = False, voxel_size: Tuple[float, float] = (0.2, 0.2),
                 pc_range: Tuple[float, float] = (0.0, -40.0)):
        super().__init__()
        self.with_distance = with_distance
        self.voxel_size, self.pc_range = tuple(voxel_size), tuple(pc_range)
        cin = num_input_features + 5 + int(with_distance)
        self.linears = nn.ModuleList()
        self.norms = nn.ModuleList()
        for out_f in num_filters:
            self.linears.append(nn.Linear(cin, out_f, bias=False))
            self.norms.append(MaskedBatchNorm(out_f))
            cin = out_f

    def forward(self, points: torch.Tensor, point_ok: torch.Tensor,
                pillar_of_point: torch.Tensor, pillar_coords: torch.Tensor,
                pillar_valid: torch.Tensor) -> torch.Tensor:
        """points [B, P, F], point_ok [B, P], pillar_of_point [B, P] (M: no
        pillar), pillar_coords [B, M, 3] (z = 0, y, x), pillar_valid [B, M]
        -> pillar features [B, M, num_filters[-1]]."""
        B, P, _ = points.shape
        M = pillar_coords.shape[1]
        okf = point_ok.to(points.dtype)[..., None]
        pid = pillar_of_point.long()

        xyz = points[..., :3]
        s = points.new_zeros(B, M + 1, 3).scatter_add_(1, pid[..., None].expand(B, P, 3),
                                                       xyz * okf)[:, :M]
        c = points.new_zeros(B, M + 1).scatter_add_(1, pid, okf[..., 0])[:, :M]
        mean_xyz = s / torch.clamp(c, min=1.0)[..., None]
        at = torch.clamp(pid, max=M - 1)
        f_cluster = xyz - torch.gather(mean_xyz, 1, at[..., None].expand(B, P, 3))
        px = pillar_coords[..., 2].to(points.dtype) * self.voxel_size[0] + (
            self.voxel_size[0] / 2 + self.pc_range[0])
        py = pillar_coords[..., 1].to(points.dtype) * self.voxel_size[1] + (
            self.voxel_size[1] / 2 + self.pc_range[1])
        centers = torch.stack([px, py], dim=-1)
        f_center = points[..., :2] - torch.gather(centers, 1, at[..., None].expand(B, P, 2))
        feats = [points, f_cluster, f_center]
        if self.with_distance:
            feats.append(torch.linalg.norm(xyz, dim=-1, keepdim=True))
        x = torch.cat(feats, dim=-1) * okf
        for linear, norm in zip(self.linears, self.norms):
            x = torch.relu(norm(linear(x), point_ok))
        C = x.shape[-1]
        tgt = torch.where(point_ok, pid, torch.full_like(pid, M))
        pooled = x.new_full((B, M + 1, C), _NEG).scatter_reduce(
            1, tgt[..., None].expand(B, P, C), x, "amax")[:, :M]
        pooled = torch.where(pooled <= _NEG, torch.zeros((), dtype=x.dtype,
                                                         device=x.device), pooled)
        return torch.where(pillar_valid[..., None], pooled,
                           torch.zeros((), dtype=x.dtype, device=x.device))


class PointPillarsScatter(nn.Module):
    """Pillar features -> the dense BEV canvas [B, ny, nx, C] (NHWC)."""

    def __init__(self, num_input_features: int = 64):
        super().__init__()
        self.num_input_features = num_input_features

    def forward(self, pillar_feats: torch.Tensor, pillar_coords: torch.Tensor,
                pillar_valid: torch.Tensor, nx: int, ny: int) -> torch.Tensor:
        B, M, C = pillar_feats.shape
        lin = pillar_coords[..., 1].long() * nx + pillar_coords[..., 2].long()
        lin = torch.where(pillar_valid, lin, torch.full_like(lin, nx * ny))
        canvas = pillar_feats.new_zeros(B, nx * ny + 1, C)
        canvas.scatter_(1, lin[..., None].expand(B, M, C), pillar_feats)
        return canvas[:, :-1].reshape(B, ny, nx, C)
