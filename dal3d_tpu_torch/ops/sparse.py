"""Sparse tensor of the gather engine and its shared compute (port of the
parts of ``dal3d_tpu/ops/sparse.py`` that the grid engine uses).

A sparse tensor is a fixed-capacity batched struct: features [B, N, C],
linear cells ``lin = (z * H + y) * W + x`` [B, N] int32, padding rows holding
the sentinel D*H*W and zero features. The grid engine (``ops/sparse_grid.py``)
keeps rows in any order. The searchsorted rulebooks of the JAX module (its
sorted-order oracle engine) are not ported: ROADMAP A9.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from . import gather as _gather


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
