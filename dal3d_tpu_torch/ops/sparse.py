"""Sparse tensor of the gather engine, its shared compute, and the
searchsorted engine (port of ``dal3d_tpu/ops/sparse.py``).

A sparse tensor is a fixed-capacity batched struct: features [B, N, C],
linear cells ``lin = (z * H + y) * W + x`` [B, N] int32, padding rows holding
the sentinel D*H*W and zero features. The grid engine (``ops/sparse_grid.py``)
keeps rows in any order and is the one the models run.

The searchsorted engine here is JAX's sorted-order oracle: ``from_voxels``
sorts the rows by cell (stable), rulebooks come from ``torch.searchsorted``
over the sorted cells, and a downsample's output set is the ``out_cap``
lowest candidate cells in ascending order (``jnp.unique(size=...)``). Its
integer plans are bit-equal to JAX's; its convs are the same
``gather_gemm`` launches as the grid engine's. No model selects it: tests and
``chip_smoke.py`` call its functions by name (``models/backbones/scn.py::
sorted_forward`` runs a gather backbone's modules on its plans), to hold the
grid engine's plans against it as sets.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from . import gather as _gather
from .sparse_brick import _decode


def _triple(x) -> Tuple[int, int, int]:
    if isinstance(x, (tuple, list)):
        if len(x) != 3:
            raise ValueError(f"expected 3 values, got {x!r}")
        return tuple(int(v) for v in x)
    return (int(x),) * 3


@dataclass
class SparseBatch:
    """Batched sparse tensor with static capacity; padding rows carry
    ``sentinel = D*H*W`` and zero features."""

    features: torch.Tensor  # [B, N, C]
    lin: torch.Tensor  # [B, N] int32
    shape: Tuple[int, int, int]  # (D, H, W)

    @property
    def sentinel(self) -> int:
        D, H, W = self.shape
        return D * H * W

    @property
    def valid(self) -> torch.Tensor:
        return self.lin < self.sentinel

    def active_sites(self) -> torch.Tensor:
        """[N, 4] int64 (b, z, y, x) of the valid rows."""
        _, H, W = self.shape
        b, n = torch.nonzero(self.valid, as_tuple=True)
        lin = self.lin[b, n].long()
        return torch.stack([b, lin // (H * W), lin // W % H, lin % W], 1)

    def replace(self, **kw) -> "SparseBatch":
        return dataclasses.replace(self, **kw)


def _kernel_offsets(kernel_size) -> np.ndarray:
    """[K, 3] (z, y, x) kernel positions in z-major order (the weight index
    order of [K, Cin, Cout] kernels)."""
    kd, kh, kw = _triple(kernel_size)
    return np.stack(np.meshgrid(np.arange(kd), np.arange(kh), np.arange(kw), indexing="ij"),
                    axis=-1).reshape(-1, 3)


def gather_gemm(features: torch.Tensor, idx: torch.Tensor, hit: torch.Tensor,
                weights: torch.Tensor, plan=None) -> torch.Tensor:
    """Core sparse conv compute: features [B, N, Cin], idx / hit [B, K, M],
    weights [K, Cin, Cout] -> [B, M, Cout], ``sum_k hit * features[b, idx] @
    W[k]``. One launch of the fused gather-GEMM kernel (``ops/gather.py``)
    on the card, its plain version on the CPU; ``plan`` is the rulebook's
    ``gather_plan`` where the caller made it once for several convs."""
    return _gather.gather_gemm(features, idx, hit, weights, plan)


def subm_conv(sb: SparseBatch, weights: torch.Tensor, rulebook=None,
              kernel_size=3) -> SparseBatch:
    """Submanifold sparse conv, weights [K, Cin, Cout]; padding rows stay 0.
    ``rulebook`` is ``(idx, hit)`` of either engine, or the grid engine's
    ``with_plan`` triple ``(idx, hit, plan)``; without one the searchsorted
    rulebook is built."""
    if rulebook is None:
        rulebook = subm_rulebook(sb, kernel_size)
    idx, hit = rulebook[:2]
    plan = (rulebook[2] if len(rulebook) > 2
            else _gather.gather_plan(idx, hit, sort=False, symmetric=True))
    out = gather_gemm(sb.features, idx, hit, weights, plan)
    out = torch.where(sb.valid[..., None], out, torch.zeros((), dtype=out.dtype,
                                                            device=out.device))
    return SparseBatch(features=out, lin=sb.lin, shape=sb.shape)


def downsample_conv(sb: SparseBatch, weights: torch.Tensor, plan) -> SparseBatch:
    """A strided conv over a downsample plan ``(out_lin, idx, hit,
    out_shape)`` of either engine; rows past the output set stay 0."""
    out_lin, idx, hit, out_shape = plan
    out = gather_gemm(sb.features, idx, hit, weights)
    keep = (out_lin < int(np.prod(out_shape)))[..., None]
    out = torch.where(keep, out, torch.zeros((), dtype=out.dtype, device=out.device))
    return SparseBatch(features=out, lin=out_lin, shape=out_shape)


# --- the searchsorted engine (JAX's sorted-order oracle) --------------------

def from_voxels(features: torch.Tensor, coords_zyx: torch.Tensor, valid: torch.Tensor,
                shape) -> SparseBatch:
    """Voxelizer output (any order) -> SparseBatch with rows sorted by cell
    (a stable sort: padding rows, all at the sentinel, keep their order).
    features [B, N, C], coords_zyx [B, N, 3], valid [B, N]."""
    D, H, W = (int(s) for s in shape)
    sentinel = D * H * W
    c = coords_zyx.long()
    lin = torch.where(valid.bool(), (c[..., 0] * H + c[..., 1]) * W + c[..., 2], sentinel)
    lin_s, order = torch.sort(lin, dim=-1, stable=True)
    feat = torch.gather(features, 1, order[..., None].expand(-1, -1, features.shape[-1]))
    feat = torch.where((lin_s < sentinel)[..., None], feat,
                       torch.zeros((), dtype=feat.dtype, device=feat.device))
    return SparseBatch(features=feat, lin=lin_s.to(torch.int32), shape=(D, H, W))


def _lookup(lin_sorted: torch.Tensor, queries: torch.Tensor, sentinel: int):
    """Binary-search lookup: lin_sorted [B, N] ascending, queries [B, Q] ->
    (idx [B, Q] int32, the left insertion point clamped to N-1; hit [B, Q],
    where the cell there is the query and below the sentinel)."""
    N = lin_sorted.shape[1]
    ls = lin_sorted.long().contiguous()
    pos = torch.clamp(torch.searchsorted(ls, queries.contiguous(), side="left"), max=N - 1)
    hit = (torch.gather(ls, 1, pos) == queries) & (queries < sentinel)
    return pos.to(torch.int32), hit


@torch.no_grad()
def subm_rulebook(sb: SparseBatch, kernel_size, grid=None):
    """Submanifold rulebook (idx [B, K, N] int32, hit [B, K, N]) of a sorted
    SparseBatch by binary search. ``grid`` is ignored (the grid engine's
    signature)."""
    D, H, W = sb.shape
    sentinel = sb.sentinel
    deltas = _kernel_offsets(kernel_size) - (np.array(_triple(kernel_size)) - 1) // 2
    d = torch.as_tensor(deltas, dtype=torch.long, device=sb.lin.device)
    lin = sb.lin.long()
    B, N = lin.shape
    K = d.shape[0]
    q = [c[:, None, :] + d[None, :, i, None] for i, c in enumerate(_decode(lin, H, W))]
    inb = ((q[0] >= 0) & (q[0] < D) & (q[1] >= 0) & (q[1] < H) & (q[2] >= 0) & (q[2] < W)
           & (lin < sentinel)[:, None, :])
    qlin = torch.where(inb, (q[0] * H + q[1]) * W + q[2], sentinel)
    idx, hit = _lookup(lin, qlin.reshape(B, K * N), sentinel)
    return idx.view(B, K, N), hit.view(B, K, N)


def _first_sorted(vals: torch.Tensor, cap: int, fill: int) -> torch.Tensor:
    """[B, L] values -> [B, cap] their distinct values in ascending order,
    the lowest ``cap`` of them, ``fill`` past the last (JAX's
    ``jnp.unique(size=cap, fill_value=fill)``), with no host sync."""
    s, _ = torch.sort(vals, dim=-1)
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    rank = torch.cumsum(first.long(), dim=-1) - 1
    tgt = torch.where(first, torch.clamp(rank, max=cap), cap)
    out = torch.full((s.shape[0], cap + 1), fill, dtype=s.dtype, device=s.device)
    out.scatter_(1, tgt, torch.where(first, s, fill))  # the slot cap is cut off
    return out[:, :cap]


@torch.no_grad()
def downsample_plan(sb: SparseBatch, kernel_size, stride, padding, out_cap: int, grid=None):
    """Strided-conv plan of a sorted SparseBatch: (out_lin [B, out_cap] int32,
    the lowest candidate cells in ascending order; idx, hit [B, K, out_cap];
    out_shape). Output cell o is active iff s*o - p + delta is an active input
    for some kernel offset delta. ``grid`` is ignored."""
    D, H, W = sb.shape
    sentinel = sb.sentinel
    ks, st, pad = _triple(kernel_size), _triple(stride), _triple(padding)
    Do, Ho, Wo = ((n + 2 * p - k) // s + 1 for n, k, s, p in zip(sb.shape, ks, st, pad))
    out_sent = Do * Ho * Wo
    dev = sb.lin.device
    offs = torch.as_tensor(_kernel_offsets(kernel_size), dtype=torch.long, device=dev)
    lin = sb.lin.long()
    B = lin.shape[0]
    ok = (lin < sentinel)[:, :, None]
    o = []
    for a, (c, dim) in enumerate(zip(_decode(lin, H, W), (Do, Ho, Wo))):
        num = c[:, :, None] + pad[a] - offs[None, None, :, a]  # [B, N, K]
        oa = torch.div(num, st[a], rounding_mode="floor")
        ok = ok & (torch.remainder(num, st[a]) == 0) & (oa >= 0) & (oa < dim)
        o.append(oa)
    olin = torch.where(ok, (o[0] * Ho + o[1]) * Wo + o[2], out_sent)
    out_lin = _first_sorted(olin.reshape(B, -1), out_cap, out_sent)

    K = offs.shape[0]
    inb = (out_lin < out_sent)[:, None, :]
    ic = []
    for a, (c, dim) in enumerate(zip(_decode(out_lin, Ho, Wo), (D, H, W))):
        ia = c[:, None, :] * st[a] - pad[a] + offs[None, :, a, None]  # [B, K, M]
        inb = inb & (ia >= 0) & (ia < dim)
        ic.append(ia)
    ilin = torch.where(inb, (ic[0] * H + ic[1]) * W + ic[2], sentinel)
    idx, hit = _lookup(lin, ilin.reshape(B, -1), sentinel)
    return (out_lin.to(torch.int32), idx.view(B, K, out_cap), hit.view(B, K, out_cap),
            (Do, Ho, Wo))


def sparse_conv_downsample(sb: SparseBatch, weights: torch.Tensor, kernel_size, stride,
                           padding, out_cap: int, grid=None) -> SparseBatch:
    """Strided sparse conv of a sorted SparseBatch onto at most ``out_cap``
    rows (the output stays sorted). ``grid`` is ignored."""
    return downsample_conv(sb, weights, downsample_plan(sb, kernel_size, stride, padding,
                                                        out_cap))


def to_dense(sb: SparseBatch) -> torch.Tensor:
    """Scatter into a dense NHWC map [B, H, W, C*D] with channel = c*D + d
    (the reference's N,C*D,H,W reshape, transposed to NHWC as in JAX)."""
    B, N, C = sb.features.shape
    D, H, W = sb.shape
    cells = D * H * W
    flat = torch.where(sb.valid, sb.lin, cells).long()
    dense = torch.zeros(B, cells + 1, C, dtype=sb.features.dtype, device=sb.features.device)
    dense.scatter_(1, flat[..., None].expand(B, N, C), sb.features)
    dense = dense[:, :cells].reshape(B, D, H, W, C)
    return dense.permute(0, 2, 3, 4, 1).reshape(B, H, W, C * D)
