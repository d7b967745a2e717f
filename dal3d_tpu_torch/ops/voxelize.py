"""Voxel grid configuration (port of ``dal3d_tpu/ops/voxelize.py::
VoxelConfig``). The device voxelizer of that module (``voxelize_mean_grid``,
``dynamic_scatter``) is not ported: ROADMAP A9. Host voxels come from
``core/voxel_generator.py``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


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
