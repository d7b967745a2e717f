"""LSS camera-to-BEV pooling (port of ``dal3d_tpu/ops/bev_pool.py``).

A scatter-add of the frustum features into a dense ``[cells + 1, C]`` table
per sample: points outside the grid go to the spare last row, which is
dropped. Plain PyTorch (``index_add``): JAX has no Pallas kernel here. On the
card ``index_add`` adds with float atomics, so a repeat may differ in the
last bits (``chip_smoke.py`` phase 19 counts the cells that do).
"""
from __future__ import annotations

import torch


def bev_pool_batched(feats: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
                     nx: int, ny: int, nz: int) -> torch.Tensor:
    """feats [B, Np, C], coords [B, Np, 3] integer (ix, iy, iz), valid [B, Np]
    -> [B, ny, nx, nz * C] with z folded into the channels (channel =
    z * C + c), as the reference's ``torch.cat(x.unbind(dim=2), 1)``.

    The features are read in place (no masked copy): an invalid point's
    row lands in the spare row whatever it holds."""
    B, Np, C = feats.shape
    cells = nz * ny * nx
    lin = (coords[..., 2].long() * ny + coords[..., 1]) * nx + coords[..., 0]
    lin = torch.where(valid, lin, torch.full_like(lin, cells))
    lin = lin + torch.arange(B, device=lin.device)[:, None] * (cells + 1)
    table = feats.new_zeros(B * (cells + 1), C).index_add(0, lin.reshape(-1),
                                                          feats.reshape(B * Np, C))
    vol = table.view(B, cells + 1, C)[:, :cells].reshape(B, nz, ny, nx, C)
    return vol.permute(0, 2, 3, 1, 4).reshape(B, ny, nx, nz * C)
