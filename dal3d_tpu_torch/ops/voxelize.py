"""Device voxelizer (port of ``dal3d_tpu/ops/voxelize.py``), plain PyTorch on
the input's device, batched over a leading B.

Points arrive as a padded [B, P, F] tensor with a validity mask [B, P]; a
point is dropped when it is invalid, outside the grid or has a non-finite
x / y / z. Every output has a fixed shape: ``max_voxel_num`` slots a frame,
``voxel_valid`` marking the filled ones, coordinates as (z, y, x). Nothing
here synchronizes with the host (no ``nonzero``, no ``.item()``).

The contract is JAX's, bit for bit in the integer outputs:

- ``voxelize`` / ``voxelize_mean``: voxels in the order of each voxel's first
  point, the first ``max_voxel_num`` voxels kept, the first
  ``max_points_in_voxel`` arrivals of a voxel kept (the reference's hard
  voxelizer); empty slots have coordinates (0, 0, 0);
- ``voxelize_mean_grid`` (the models' path) and ``dynamic_scatter``: voxels
  in ascending linear cell order, the lowest ``max_voxel_num`` cells kept, the
  mean (or max) over ALL points of a voxel; empty slots have coordinates
  (D, 0, 0), D the grid's depth. These are JAX's documented deviations from
  the hard voxelizer (which keeps first arrivals and averages the first
  ``max_points_in_voxel``), kept as they are.

The inside differs from JAX's: where JAX writes a dense occupancy grid
(``occ`` / ``vox_of_cell``: its TPU had no fast sort), the port sorts each
frame's linear cell indices (a stable ``torch.sort``), which gives the same
ascending order without writing a grid of 42M (CBGS) or 83M (BEVFusion)
cells a frame. Feature sums are ``index_add_`` in point order: on the CPU the
order of JAX's sums; on the card float atomics, whose order may vary from
run to run (the integer outputs do not)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class VoxelConfig:
    point_cloud_range: Tuple[float, ...]  # (x0, y0, z0, x1, y1, z1)
    voxel_size: Tuple[float, ...]  # (vx, vy, vz)
    max_points_in_voxel: int = 10
    max_voxel_num: int = 60000

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        """(Nx, Ny, Nz) = round(range / voxel_size), as the reference."""
        r = np.asarray(self.point_cloud_range)
        vs = np.asarray(self.voxel_size)
        g = np.round((r[3:] - r[:3]) / vs).astype(np.int64)
        return int(g[0]), int(g[1]), int(g[2])

    @property
    def sparse_shape(self) -> Tuple[int, int, int]:
        """(D, H, W) sparse input shape = grid[::-1] + (1, 0, 0)."""
        nx, ny, nz = self.grid_size
        return nz + 1, ny, nx


def _cells(points: torch.Tensor, valid: torch.Tensor, cfg: VoxelConfig):
    """(ok [B, P], lin [B, P] int64): whether a point is kept, and its linear
    cell (z * Ny + y) * Nx + x, Nx * Ny * Nz for a dropped point. The cell is
    floor((xyz - range_min) / voxel_size) in the points' dtype, as JAX's; the
    grid test runs on the floored values, so a value past int32 is out of the
    grid as it is in JAX's saturated cast."""
    if points.dim() != 3 or valid.shape != points.shape[:2]:
        raise ValueError(f"points must be [B, P, F] with valid [B, P], got "
                         f"{tuple(points.shape)} and {tuple(valid.shape)}")
    nx, ny, nz = cfg.grid_size
    kw = dict(dtype=points.dtype, device=points.device)
    xyz = points[..., :3]
    fl = torch.floor((xyz - torch.tensor(cfg.point_cloud_range[:3], **kw))
                     / torch.tensor(cfg.voxel_size, **kw))
    in_grid = ((fl >= 0) & (fl < torch.tensor([nx, ny, nz], **kw))).all(-1)
    ok = valid.bool() & in_grid & torch.isfinite(xyz).all(-1)
    c = torch.where(ok[..., None], fl, torch.zeros((), **kw)).long()
    lin = (c[..., 2] * ny + c[..., 1]) * nx + c[..., 0]
    return ok, torch.where(ok, lin, nx * ny * nz)


def _runs(lin: torch.Tensor, cells: int):
    """Stable sort of each frame's cells: (sorted cells, permutation, whether
    a sorted point is kept, whether it starts its voxel's run, the run's rank
    in ascending cell order)."""
    key, perm = torch.sort(lin, dim=1, stable=True)
    ok_s = key < cells
    start = ok_s.clone()
    start[:, 1:] &= key[:, 1:] != key[:, :-1]
    rank = torch.cumsum(start, dim=1) - 1
    return key, perm, ok_s, start, rank


def _unsort(vals: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Values of the sorted points back in point order."""
    return torch.empty_like(vals).scatter_(1, perm, vals)


def _segment_sum(vals: torch.Tensor, vid: torch.Tensor, M: int) -> torch.Tensor:
    """[B, P, F] summed into [B, M + 1, F] by voxel id [B, P] (M: dropped),
    in point order."""
    B, P, F = vals.shape
    base = torch.arange(B, device=vid.device)[:, None] * (M + 1)
    out = vals.new_zeros((B * (M + 1), F))
    out.index_add_(0, (vid + base).reshape(-1), vals.reshape(B * P, F))
    return out.view(B, M + 1, F)


def _grid_coords(cell_list: torch.Tensor, cfg: VoxelConfig) -> torch.Tensor:
    nx, ny, _ = cfg.grid_size
    z = cell_list // (nx * ny)
    rem = cell_list % (nx * ny)
    return torch.stack([z, rem // nx, rem % nx], dim=-1).int()


def _voxel_index(points: torch.Tensor, valid: torch.Tensor, cfg: VoxelConfig):
    """The sort variants' shared pass. Per sorted point: ``new_id`` (voxel
    slot in first-appearance order, M when dropped), ``slot`` (arrival index
    within its voxel), ``perm`` (sorted position -> point index); per voxel:
    coords [B, M, 3] (z, y, x; empty slots 0), num_points [B, M] (capped at
    ``max_points_in_voxel``), voxel_valid [B, M]."""
    B, P, _ = points.shape
    M = cfg.max_voxel_num
    nx, ny, nz = cfg.grid_size
    cells = nx * ny * nz
    ok, lin = _cells(points, valid, cfg)
    key, perm, ok_s, start, run = _runs(lin, cells)
    pos = torch.arange(P, device=points.device).expand(B, P)
    seg_start = torch.cummax(torch.where(start, pos, -1), dim=1).values
    slot = pos - seg_start
    # first point of each run (the stable sort keeps arrival order in a run);
    # runs ranked by it give the first-appearance order
    first = torch.full((B, P + 1), P + 1, dtype=torch.long, device=points.device)
    first.scatter_(1, torch.where(start, run, P), torch.where(start, perm, P + 1))
    first[:, P] = P + 1
    appear = torch.sort(first, dim=1, stable=True).indices
    new_of_run = torch.empty_like(appear).scatter_(
        1, appear, torch.arange(P + 1, device=points.device).expand(B, P + 1))
    new_id = torch.gather(new_of_run, 1, torch.where(ok_s, run, P))
    new_id = torch.where(ok_s & (new_id < M), new_id, M)

    # cells of the kept voxels: the first point of each run writes its
    # voxel's slot; an empty slot keeps cell 0, i.e. coordinates (0, 0, 0)
    first_pt = start & (new_id < M)
    cell = torch.zeros((B, M + 1), dtype=torch.long, device=points.device)
    cell.scatter_(1, torch.where(first_pt, new_id, M), torch.where(first_pt, key, 0))
    counts = torch.zeros((B, M + 1), dtype=torch.int32, device=points.device)
    counts.scatter_add_(1, new_id, torch.ones_like(new_id, dtype=torch.int32))
    counts = counts[:, :M]
    num_points = torch.clamp(counts, max=cfg.max_points_in_voxel)
    return new_id, slot, perm, _grid_coords(cell[:, :M], cfg), num_points, counts > 0


def voxelize(points: torch.Tensor, valid: torch.Tensor, cfg: VoxelConfig) -> Dict:
    """Full voxel tensors (PillarFeatureNet-style encoders): points [B, P, F],
    valid [B, P] -> voxels [B, M, K, F] (the first K arrivals of each voxel,
    zero-padded), num_points [B, M], coordinates [B, M, 3] (z, y, x),
    voxel_valid [B, M], num_voxels [B]."""
    B, P, F = points.shape
    M, K = cfg.max_voxel_num, cfg.max_points_in_voxel
    new_id, slot, perm, coords, num_points, voxel_valid = _voxel_index(points, valid, cfg)
    pts_s = torch.gather(points, 1, perm[..., None].expand(B, P, F))
    keep = (slot < K) & (new_id < M)
    flat = torch.where(keep, new_id * K + slot, M * K)
    voxels = points.new_zeros((B, M * K + 1, F))
    voxels.scatter_(1, flat[..., None].expand(B, P, F), torch.where(keep[..., None], pts_s, 0))
    return {
        "voxels": voxels[:, : M * K].reshape(B, M, K, F),
        "num_points": num_points,
        "coordinates": coords,
        "voxel_valid": voxel_valid,
        "num_voxels": voxel_valid.sum(1),
    }


def voxelize_mean(points: torch.Tensor, valid: torch.Tensor, cfg: VoxelConfig) -> Dict:
    """Fused voxelize + per-voxel mean over each voxel's first
    ``max_points_in_voxel`` arrivals (the mean VFE), without the [M, K, F]
    tensor: features [B, M, F], num_points, coordinates, voxel_valid,
    num_voxels."""
    B, P, F = points.shape
    M, K = cfg.max_voxel_num, cfg.max_points_in_voxel
    new_id, slot, perm, coords, num_points, voxel_valid = _voxel_index(points, valid, cfg)
    pts_s = torch.gather(points, 1, perm[..., None].expand(B, P, F))
    keep = (slot < K) & (new_id < M)
    feat_sum = _segment_sum(torch.where(keep[..., None], pts_s, 0),
                            torch.where(keep, new_id, M), M)[:, :M]
    denom = torch.clamp(num_points, min=1).to(points.dtype)
    return {
        "features": feat_sum / denom[..., None],
        "num_points": num_points,
        "coordinates": coords,
        "voxel_valid": voxel_valid,
        "num_voxels": voxel_valid.sum(1),
    }


def _grid_ids(points: torch.Tensor, valid: torch.Tensor, cfg: VoxelConfig):
    """The grid variants' pass: (ok [B, P], voxel id [B, P] in point order,
    M for a dropped point or a cell past the M lowest, cell_list [B, M]: the
    M lowest occupied cells ascending, Nx * Ny * Nz in empty slots)."""
    M = cfg.max_voxel_num
    nx, ny, nz = cfg.grid_size
    cells = nx * ny * nz
    ok, lin = _cells(points, valid, cfg)
    key, perm, ok_s, start, rank = _runs(lin, cells)
    kept = ok_s & (rank < M)
    cell_list = torch.full((lin.shape[0], M + 1), cells, dtype=torch.long, device=lin.device)
    cell_list.scatter_(1, torch.where(start & kept, rank, M), key)
    vid = _unsort(torch.where(kept, rank, M), perm)
    return ok, vid, cell_list[:, :M]


def voxelize_mean_grid(points: torch.Tensor, valid: torch.Tensor, cfg: VoxelConfig) -> Dict:
    """Voxelize + per-voxel mean, voxels in ascending cell order (the models'
    path, JAX's ``sort_free_voxelize``): points [B, P, F], valid [B, P] ->
    features [B, M, F] (mean of all the voxel's points), num_points [B, M]
    (all of them), coordinates [B, M, 3] (z, y, x), voxel_valid [B, M],
    num_voxels [B]."""
    M = cfg.max_voxel_num
    nx, ny, nz = cfg.grid_size
    ok, vid, cell_list = _grid_ids(points, valid, cfg)
    feat_sum = _segment_sum(torch.where(ok[..., None], points, 0), vid, M)[:, :M]
    count = _segment_sum(ok[..., None].int(), vid, M)[:, :M, 0]
    features = feat_sum / torch.clamp(count, min=1)[..., None].to(points.dtype)
    voxel_valid = (count > 0) & (cell_list < nx * ny * nz)
    return {
        "features": features,
        "num_points": count,
        "coordinates": _grid_coords(cell_list, cfg),
        "voxel_valid": voxel_valid,
        "num_voxels": voxel_valid.sum(1),
    }


def dynamic_scatter(points: torch.Tensor, valid: torch.Tensor, cfg: VoxelConfig,
                    reduce: str = "mean") -> Dict:
    """DynamicScatter (the reference's mmdet3d scatter_points): per-voxel
    mean or max of the point features on the grid variant's voxels. Returns
    features [B, M, F], coordinates [B, M, 3], voxel_valid [B, M], num_voxels
    [B] (the mean also num_points)."""
    if reduce == "mean":
        return voxelize_mean_grid(points, valid, cfg)
    if reduce != "max":
        raise ValueError(f"reduce={reduce!r}: 'mean' or 'max'")
    B, P, F = points.shape
    M = cfg.max_voxel_num
    nx, ny, nz = cfg.grid_size
    ok, vid, cell_list = _grid_ids(points, valid, cfg)
    fmax = points.new_full((B, M + 1, F), -float("inf"))
    fmax.scatter_reduce_(1, vid[..., None].expand(B, P, F),
                         torch.where(ok[..., None], points, -float("inf")), reduce="amax")
    fmax = fmax[:, :M]
    voxel_valid = cell_list < nx * ny * nz
    return {
        "features": torch.where(torch.isfinite(fmax), fmax, 0),
        "coordinates": _grid_coords(cell_list, cfg),
        "voxel_valid": voxel_valid,
        "num_voxels": voxel_valid.sum(1),
    }
