"""Sort-free sparse conv engine on dense index grids (port of
``dal3d_tpu/ops/sparse_grid.py``).

- ``build_index_grid``: ``grid[cell] = row`` (int32 [B, D*H*W + 1], -1 for an
  empty cell); at BEVFusion's L0 (41, 1440, 1440) that is 340 MB per frame.
- Submanifold rulebook: neighbour row = ``grid[lin + dlin]``, bounds-checked.
- Strided downsample: mark the candidate output cells in a dense occupancy
  grid, compact them with a cumsum rank (ascending cell order, the lowest
  first on overflow, as JAX's ``jnp.nonzero(size=cap)``; no sort and no
  host sync), then look the rulebook up in the input grid.

Rulebooks come in JAX's form, ``(max(idx, 0), hit)``, and plans are built on
the tensor's device outside the graph; they are bit-identical to JAX's. The
compute is ``ops/sparse.py::gather_gemm`` (the fused gather-GEMM kernel).
Rows are not kept sorted: padding rows carry ``lin == D*H*W``. A rulebook
that several convs share carries the kernel's walk plan made once
(``with_plan``: ``(idx, hit, plan)``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .gather import gather_plan
from .sparse import SparseBatch, _kernel_offsets, _triple, gather_gemm
from .sparse_brick import _decode, _rank_first


def _lookup(grid: torch.Tensor, cells: torch.Tensor):
    """grid [B, cells+1], cells [B, K, M] long (cells = miss) -> (max(row, 0)
    int32, hit) [B, K, M]."""
    B = grid.shape[0]
    idx = torch.gather(grid, 1, cells.reshape(B, -1)).reshape(cells.shape)
    hit = idx >= 0
    return torch.clamp(idx, min=0), hit


@torch.no_grad()
def build_index_grid(sb: SparseBatch) -> torch.Tensor:
    """[B, D*H*W+1] int32: cell -> row index, -1 if empty (the sentinel cell
    stays -1)."""
    D, H, W = sb.shape
    cells = D * H * W
    B, N = sb.lin.shape
    lin = sb.lin.long()
    ok = lin < cells
    rows = torch.arange(N, dtype=torch.int32, device=lin.device).expand(B, N)
    grid = torch.full((B, cells + 1), -1, dtype=torch.int32, device=lin.device)
    grid.scatter_(1, torch.where(ok, lin, cells), torch.where(ok, rows, -1))
    grid[:, cells] = -1
    return grid


def _delta_lins(kernel_size, shape) -> Tuple[np.ndarray, np.ndarray]:
    """Per-offset (dz, dy, dx) [K, 3] and their linear deltas [K] for a grid
    shape."""
    D, H, W = shape
    deltas = _kernel_offsets(kernel_size) - (np.array(_triple(kernel_size)) - 1) // 2
    dlin = (deltas[:, 0] * H + deltas[:, 1]) * W + deltas[:, 2]
    return deltas, dlin


@torch.no_grad()
def subm_rulebook(sb: SparseBatch, kernel_size, grid: torch.Tensor | None = None):
    """(idx [B, K, N] int32, hit [B, K, N] bool) via index-grid gathers."""
    D, H, W = sb.shape
    cells = D * H * W
    if grid is None:
        grid = build_index_grid(sb)
    deltas, dlin = _delta_lins(kernel_size, sb.shape)
    dev = sb.lin.device
    d = torch.as_tensor(deltas, dtype=torch.long, device=dev)[None, :, :, None]  # [1,K,3,1]
    dl = torch.as_tensor(dlin, dtype=torch.long, device=dev)[None, :, None]
    lin = sb.lin.long()
    z, y, x = _decode(lin, H, W)
    qz, qy, qx = (c[:, None, :] + d[:, :, i] for i, c in enumerate((z, y, x)))
    inb = ((qz >= 0) & (qz < D) & (qy >= 0) & (qy < H) & (qx >= 0) & (qx < W)
           & (lin < cells)[:, None, :])
    return _lookup(grid, torch.where(inb, lin[:, None, :] + dl, cells))


def _out_shape(shape, kernel_size, stride, padding):
    return tuple((n + 2 * p - k) // s + 1 for n, k, s, p in
                 zip(shape, _triple(kernel_size), _triple(stride), _triple(padding)))


@torch.no_grad()
def downsample_plan(sb: SparseBatch, kernel_size, stride, padding, out_cap: int,
                    grid: torch.Tensor | None = None):
    """Sort-free strided-conv plan. Returns (out_lin [B, M] int32 in
    ascending cell order, idx [B, K, M] int32, hit [B, K, M], out_shape)."""
    D, H, W = sb.shape
    cells = D * H * W
    Do, Ho, Wo = _out_shape(sb.shape, kernel_size, stride, padding)
    out_cells = Do * Ho * Wo
    if grid is None:
        grid = build_index_grid(sb)
    dev = sb.lin.device
    B = sb.lin.shape[0]
    offs = torch.as_tensor(_kernel_offsets(kernel_size), dtype=torch.long, device=dev)
    st, pad = _triple(stride), _triple(padding)
    lin = sb.lin.long()
    c = _decode(lin, H, W)
    # candidates: o = (i + p - delta) / s where divisible and in range
    ok = (lin < cells)[:, :, None]
    o = []
    for a, dim in enumerate((Do, Ho, Wo)):
        num = c[a][:, :, None] + pad[a] - offs[None, None, :, a]  # [B, N, K]
        oa = torch.div(num, st[a], rounding_mode="floor")
        ok = ok & (torch.remainder(num, st[a]) == 0) & (oa >= 0) & (oa < dim)
        o.append(oa)
    olin = torch.where(ok, (o[0] * Ho + o[1]) * Wo + o[2], out_cells)
    occ = torch.zeros(B, out_cells + 1, dtype=torch.long, device=dev)
    occ.scatter_(1, olin.reshape(B, -1), 1)
    out_lin = _rank_first(occ[:, :out_cells], out_cap, out_cells)

    # rulebook: the input cell of each (output, delta) is s*o - p + delta
    oc = _decode(out_lin, Ho, Wo)
    inb = (out_lin < out_cells)[:, None, :]
    ic = []
    for a, dim in enumerate((D, H, W)):
        ia = oc[a][:, None, :] * st[a] - pad[a] + offs[None, :, a, None]  # [B, K, M]
        inb = inb & (ia >= 0) & (ia < dim)
        ic.append(ia)
    idx, hit = _lookup(grid, torch.where(inb, (ic[0] * H + ic[1]) * W + ic[2], cells))
    return out_lin.to(torch.int32), idx, hit, (Do, Ho, Wo)


def with_plan(rulebook):
    """(idx, hit) -> (idx, hit, plan): a rulebook shared by several convs,
    with the gather-GEMM kernel's walk plan (``ops/gather.py::gather_plan``)
    made once for all of them."""
    idx, hit = rulebook
    return idx, hit, gather_plan(idx, hit)


def subm_conv(sb: SparseBatch, weights: torch.Tensor, rulebook=None,
              kernel_size=3) -> SparseBatch:
    """Submanifold sparse conv, weights [K, Cin, Cout]; padding rows stay 0.
    ``rulebook`` is ``(idx, hit)`` or ``with_plan``'s ``(idx, hit, plan)``."""
    if rulebook is None:
        rulebook = subm_rulebook(sb, kernel_size)
    idx, hit = rulebook[:2]
    out = gather_gemm(sb.features, idx, hit, weights, rulebook[2] if len(rulebook) > 2 else None)
    out = torch.where(sb.valid[..., None], out, torch.zeros((), dtype=out.dtype,
                                                            device=out.device))
    return SparseBatch(features=out, lin=sb.lin, shape=sb.shape)


def sparse_conv_downsample(sb: SparseBatch, weights: torch.Tensor, kernel_size, stride,
                           padding, out_cap: int, grid=None) -> SparseBatch:
    """Strided (non-submanifold) sparse conv onto a new active set of at most
    ``out_cap`` rows."""
    out_lin, idx, hit, out_shape = downsample_plan(sb, kernel_size, stride, padding,
                                                   out_cap, grid)
    out = gather_gemm(sb.features, idx, hit, weights)
    keep = (out_lin < int(np.prod(out_shape)))[..., None]
    out = torch.where(keep, out, torch.zeros((), dtype=out.dtype, device=out.device))
    return SparseBatch(features=out, lin=out_lin, shape=out_shape)


def from_voxels(features: torch.Tensor, coords_zyx: torch.Tensor, valid: torch.Tensor,
                shape) -> SparseBatch:
    """Voxelizer output -> SparseBatch (rows stay in voxel order, no sort).
    features [B, N, C], coords_zyx [B, N, 3], valid [B, N]."""
    D, H, W = (int(s) for s in shape)
    valid = valid.bool()
    c = coords_zyx.long()
    lin = (c[..., 0] * H + c[..., 1]) * W + c[..., 2]
    lin = torch.where(valid, lin, D * H * W).to(torch.int32)
    feats = torch.where(valid[..., None], features, torch.zeros((), dtype=features.dtype,
                                                                device=features.device))
    return SparseBatch(features=feats, lin=lin, shape=(D, H, W))
