"""Fused gather-GEMM and row gather of the gather sparse-conv engine (port of
``dal3d_tpu/ops/pallas_gather.py``).

    gather_gemm:  out[b, m] = sum_k hit[b, k, m] * features[b, idx[b, k, m]] @ W[k]
    gather_rows:  out[m] = rows(table)[idx[m]]

``gather_gemm`` is the compute of every convolution of the gather engine
(``ops/sparse_grid.py``), so of every conv of BEVFusion's SparseEncoder;
``gather_rows`` is TransFusion's query gather. Each wrapper runs its plain
PyTorch version for a CPU tensor and launches its CUDA kernel
(``csrc/gather.cu``) for a CUDA tensor, or raises; ``<wrapper>.launches``
counts the kernel launches.

The grid engine hands over JAX's rulebook form, ``max(idx, 0)`` with a
separate ``hit``. ``gather_plan`` turns it, once per rulebook, into what the
kernel walks: the rulebook with -1 for a miss (the kernel zero-fills such a
row: a miss adds exactly 0) and, for a rulebook that several convs share,
its rows grouped by their set of hit taps with the permutation that puts
each output row back in its place.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .banded import _acc_dtype

GEMM_MAX_TAPS = 32  # the kernel's tap masks are 32-bit
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_GEMM_ARGS = [_P] * 5 + [_I] * 6
_ROWS_ARGS = [_P] * 3 + [_I] + [_L] * 5 + [_I] * 2


def _cout_pad(cout: int) -> int:
    """The kernel's column tiles: 16, 32, 64, or a multiple of 128."""
    for c in (16, 32, 64):
        if cout <= c:
            return c
    return -(-cout // 128) * 128


def gemm_tile_rows(cout: int) -> tuple:
    """(plan positions of a block, rows of a warp's group) of the kernel for
    this Cout (csrc/gather.cu): 128-row blocks of 8 row groups of 16 below
    64, of 4 groups of 32 from 64 on."""
    return 128, 32 if _cout_pad(cout) >= 64 else 16


class GatherPlan(NamedTuple):
    """What the fused gather-GEMM kernel walks for one rulebook."""

    rulebook: torch.Tensor  # [B, K, M] int32, rows in plan order, -1 = miss
    # [B, M] int64: the output row of each plan position; None: rows in order
    order: torch.Tensor | None


_TAP_BITS: dict = {}


def _tap_bits(K: int, dtype, device) -> torch.Tensor:
    """[K, 1] 2^(K-1-k): tap 0 the highest bit of a row's hit mask (cached)."""
    c = _TAP_BITS.get((K, dtype, device))
    if c is None:
        c = _TAP_BITS[(K, dtype, device)] = torch.tensor(
            [[1 << (K - 1 - k)] for k in range(K)], dtype=dtype, device=device)
    return c


@torch.no_grad()
def gather_plan(idx: torch.Tensor, hit: torch.Tensor, sort: bool = True) -> GatherPlan:
    """The plan of a rulebook (idx, hit) [B, K, M]. ``sort``: the rows
    sorted (stably) by their hit mask, tap 0 as its highest bit, so that rows
    hitting the same taps share tiles and a tile's taps are few (the
    ordering of spconv 2's implicit GEMM); for a rulebook that several convs
    share. Without it the rows keep their order: for a rulebook used once,
    whose sort would cost about what it saves (phase 12 of chip_smoke.py).
    Plain PyTorch on any device. K <= 32."""
    B, K, M = idx.shape
    if K > GEMM_MAX_TAPS:
        raise ValueError(f"gather_plan: at most {GEMM_MAX_TAPS} taps, got {K}")
    if not sort:
        return GatherPlan(torch.where(hit, idx, -1), None)
    dt = torch.int32 if K <= 31 else torch.int64
    key = torch.where(hit, _tap_bits(K, dt, idx.device), 0).sum(1, dtype=dt)
    order = key.argsort(dim=1, stable=True)
    rb = torch.where(hit, idx, -1).gather(2, order[:, None, :].expand(B, K, M))
    return GatherPlan(rb, order)


@torch.no_grad()
def gemm_walk(plan: GatherPlan, cout: int):
    """The kernel's walk over a plan, for one column tile: (tap masks of
    its blocks [B, T, K], of the warps' row groups [B, T * G, K]).
    A block steps through the taps its rows hit; a row group stages and
    multiplies only the taps its own rows hit."""
    B, K, M = plan.rulebook.shape
    bm, wr = gemm_tile_rows(cout)
    T = -(-M // bm)
    hit = F.pad(plan.rulebook >= 0, (0, T * bm - M))
    groups = hit.view(B, K, T * bm // wr, wr).any(-1).transpose(1, 2)
    return groups.reshape(B, T, -1, K).any(2), groups


def gather_gemm_plain(features: torch.Tensor, idx: torch.Tensor, hit: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the zero-row gather and a per-tap
    matmul in f32, rounded to the features' dtype (the twin of
    ``dal3d_tpu/ops/sparse.py::gather_gemm``). features [B, N, Cin], idx /
    hit [B, K, M], weights [K, Cin, Cout] -> [B, M, Cout]."""
    B, N, Cin = features.shape
    K, M = idx.shape[1], idx.shape[2]
    acc = _acc_dtype(features.dtype)
    tbl = torch.cat([features, features.new_zeros(B, 1, Cin)], dim=1)
    safe = torch.where(hit, idx.long(), N)
    out = torch.zeros(B, M, weights.shape[-1], dtype=acc, device=features.device)
    for k in range(K):
        g = torch.gather(tbl, 1, safe[:, k, :, None].expand(B, M, Cin))
        out += torch.matmul(g.to(acc), weights[k].to(acc))
    return out.to(features.dtype)


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the row gather: ``table[idx]`` for a table
    [N, C]; for [B, R, C] the rows in (batch, row) order, by advanced
    indexing on the same view (no copy of the table)."""
    i = idx.long()
    if table.dim() == 2:
        return table[i]
    R = table.shape[1]
    return table[torch.div(i, R, rounding_mode="floor"), torch.remainder(i, R)]


def gather_gemm(features: torch.Tensor, idx: torch.Tensor, hit: torch.Tensor,
                weights: torch.Tensor, plan: GatherPlan | None = None) -> torch.Tensor:
    """The fused gather-GEMM's wrapper (``ops/sparse.py::gather_gemm``
    semantics): features [B, N, Cin], idx [B, K, M] int32 in [0, N), hit
    [B, K, M] bool, weights [K, Cin, Cout] -> [B, M, Cout] in the features'
    dtype. ``plan`` is ``gather_plan(idx, hit)``, made once by a caller whose
    rulebook serves several convs; made here (rows in order) when not given.

    CPU tensors take the plain version. CUDA tensors (f32, the type of the
    gather engine's convs) launch ``csrc/gather.cu`` (3xTF32 on the tensor
    cores) or raise; Cin is zero-padded to a multiple of 4 and Cout to the
    kernel's column tile where needed (the stem's 5 channels; every other
    conv of the path is aligned)."""
    if features.device.type == "cpu":
        return gather_gemm_plain(features, idx, hit, weights)
    if features.device.type != "cuda":
        raise ValueError(f"gather_gemm: unsupported device {features.device}")
    if features.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError(f"gather_gemm: features {features.dtype} / weights {weights.dtype}; "
                        "the kernel takes f32")
    B, N, Cin = features.shape
    K, M = idx.shape[1], idx.shape[2]
    Cout = weights.shape[-1]
    if (idx.dtype != torch.int32 or hit.dtype != torch.bool or idx.shape[0] != B
            or hit.shape != idx.shape or weights.shape[:2] != (K, Cin)):
        raise ValueError(f"gather_gemm: shapes features {tuple(features.shape)}, "
                         f"idx {tuple(idx.shape)} {idx.dtype}, hit {tuple(hit.shape)} "
                         f"{hit.dtype}, weights {tuple(weights.shape)}")
    if not (idx.device == hit.device == weights.device == features.device):
        raise ValueError("gather_gemm: inputs must be on one device")
    if plan is None:
        plan = gather_plan(idx, hit, sort=False)
    elif (plan.rulebook.shape != idx.shape or plan.rulebook.device != features.device
          or (plan.order is not None and (plan.order.shape != (B, M)
                                          or plan.order.device != features.device))):
        raise ValueError("gather_gemm: the plan is not this rulebook's")
    Cinp, Coutp = -(-Cin // 4) * 4, _cout_pad(Cout)
    if Cinp != Cin:
        features = F.pad(features, (0, Cinp - Cin))
    if Cinp != Cin or Coutp != Cout:
        weights = F.pad(weights, (0, Coutp - Cout, 0, Cinp - Cin))
    features, weights = features.contiguous(), weights.contiguous()
    out = torch.empty(B, M, Coutp, dtype=torch.float32, device=features.device)
    _build.function("gather", "gather_gemm_f32", _GEMM_ARGS, "gather_gemm")(
        features.device, features.data_ptr(), plan.rulebook.data_ptr(),
        0 if plan.order is None else plan.order.data_ptr(),
        weights.data_ptr(), out.data_ptr(), B, N, Cinp, K, M, Coutp)
    gather_gemm.launches += 1
    return out[..., :Cout] if Coutp != Cout else out


gather_gemm.launches = 0


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The row gather's wrapper: table [N, C] or [B, R, C] of any strides
    (a permuted view is read where it lies), idx [M] int32 over the table's
    rows in (batch, row) order -> [M, C] contiguous in the table's dtype
    (JAX's ``gather_rows`` without its ``M % block_m == 0`` rule and its
    128-lane padding).

    CPU tensors take the plain version. CUDA tensors launch
    ``csrc/gather.cu`` or raise; there an index outside the rows gives a zero
    row, and each output row is a bit-exact copy."""
    dev = table.device
    if dev.type == "cpu":
        return gather_rows_plain(table, idx)
    if dev.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {dev}")
    if table.dim() not in (2, 3) or idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"gather_rows: table {tuple(table.shape)}, idx {tuple(idx.shape)} "
                         f"{idx.dtype}; expected [N, C] or [B, R, C] and [M] int32")
    if idx.device != dev:
        raise ValueError("gather_rows: inputs must be on one device")
    if table.dim() == 3:
        Bt, R, C = table.shape
        sb, sr, sc = table.stride()
    else:
        (R, C), (sr, sc), Bt, sb = table.shape, table.stride(), 1, 0
    es = table.element_size()
    row_bytes = C * es
    if sc == 1 or C == 1:  # contiguous rows: the widest piece that keeps every start aligned
        v = row_bytes | table.data_ptr() | (sr * es if R > 1 else 0) | (sb * es if Bt > 1 else 0)
        piece = min(16, v & -v) if v else 16
        sp = piece
    else:  # element-strided rows (a permuted view): one element a piece
        piece, sp = es, sc * es
    if not idx.is_contiguous():
        idx = idx.contiguous()
    M = idx.shape[0]
    out = torch.empty((M, C), dtype=table.dtype, device=dev)
    _build.function("gather", "gather_rows", _ROWS_ARGS)(
        dev, table.data_ptr(), idx.data_ptr(), out.data_ptr(), M, Bt * R, max(R, 1),
        sb * es, sr * es, sp, piece, row_bytes)
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
