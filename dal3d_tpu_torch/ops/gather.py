"""Fused gather-GEMM and row gather of the gather sparse-conv engine (port of
``dal3d_tpu/ops/pallas_gather.py``), with their gradients.

    gather_gemm:  out[b, m] = sum_k hit[b, k, m] * features[b, idx[b, k, m]] @ W[k]
    gather_rows:  out[m] = rows(table)[idx[m]]
    gather_dw:    dW[k] = sum_{b, m} hit[b, k, m] * features[b, idx[b, k, m]]^T g[b, m]

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

Gradients (JAX takes them by XLA autodiff of ``ops/sparse.py::gather_gemm``
and of ``take_along_axis``; it has no Pallas backward). On the card each
launch sits in a ``torch.autograd.Function``, the padding and slicing around
it stay with autograd:

- the input gradient is K4 again: for a fixed tap the map output -> input is
  injective, so dX[n] = sum_k g[inv[k, n]] @ W[k]^T over the per-tap inverse
  rulebook. A submanifold rulebook is its own inverse with the taps reversed
  (``GatherPlan.symmetric``: the same plan, weights ``W.flip(0)^T``); any
  other (the strided convs) gets its inverse by one int ``scatter_``
  (``inverse_plan``);
- the weight gradient is its own kernel (``gather_dw``, ``csrc/gather.cu``)
  walking the forward's plan;
- the row gather's backward is a scatter-add of the rows' gradients
  (``index_add_``: float atomics on the card, so not bit-repeatable there).

The plain versions are differentiable as they are and are the CPU path.
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
_DW_ARGS = [_P] * 6 + [_I] * 8
DW_CHUNK = 32  # plan positions of one reduction step of the dW kernel
DW_MAX_CHUNKS = 1024  # chunks of one share (the kernel's shared-memory lists)
_DW_BLOCKS = 528  # blocks a dW launch aims at: four per multiprocessor of an H100


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
    # a submanifold rulebook (M == N, tap K-1-k the inverse of tap k): the
    # input gradient walks this plan again
    symmetric: bool = False


_TAP_BITS: dict = {}


def _tap_bits(K: int, dtype, device) -> torch.Tensor:
    """[K, 1] 2^(K-1-k): tap 0 the highest bit of a row's hit mask (cached)."""
    c = _TAP_BITS.get((K, dtype, device))
    if c is None:
        c = _TAP_BITS[(K, dtype, device)] = torch.tensor(
            [[1 << (K - 1 - k)] for k in range(K)], dtype=dtype, device=device)
    return c


@torch.no_grad()
def gather_plan(idx: torch.Tensor, hit: torch.Tensor, sort: bool = True,
                symmetric: bool = False) -> GatherPlan:
    """The plan of a rulebook (idx, hit) [B, K, M]. ``sort``: the rows
    sorted (stably) by their hit mask, tap 0 as its highest bit, so that rows
    hitting the same taps share tiles and a tile's taps are few (the
    ordering of spconv 2's implicit GEMM); for a rulebook that several convs
    share. Without it the rows keep their order: for a rulebook used once,
    whose sort would cost about what it saves (phase 12 of chip_smoke.py).
    ``symmetric``: the caller states that the rulebook is submanifold (see
    ``GatherPlan``). Plain PyTorch on any device. K <= 32."""
    B, K, M = idx.shape
    if K > GEMM_MAX_TAPS:
        raise ValueError(f"gather_plan: at most {GEMM_MAX_TAPS} taps, got {K}")
    if not sort:
        return GatherPlan(torch.where(hit, idx, -1), None, symmetric)
    dt = torch.int32 if K <= 31 else torch.int64
    key = torch.where(hit, _tap_bits(K, dt, idx.device), 0).sum(1, dtype=dt)
    order = key.argsort(dim=1, stable=True)
    rb = torch.where(hit, idx, -1).gather(2, order[:, None, :].expand(B, K, M))
    return GatherPlan(rb, order, symmetric)


@torch.no_grad()
def inverse_plan(plan: GatherPlan, n_rows: int) -> GatherPlan:
    """The plan of the input gradient of a rulebook that is not symmetric
    (a strided conv): ``inv[b, k, n]`` = the output row whose tap k reads
    input row n, -1 where none does. For a fixed tap each input row is read
    by at most one output row, so one int ``scatter_`` over all taps builds
    it (misses go to a dump column that is cut off); rows in order."""
    rb = plan.rulebook
    B, K, M = rb.shape
    src = (plan.order.to(torch.int32)[:, None, :] if plan.order is not None else
           torch.arange(M, dtype=torch.int32, device=rb.device)[None, None, :])
    inv = torch.full((B, K, n_rows + 1), -1, dtype=torch.int32, device=rb.device)
    inv.scatter_(2, torch.where(rb >= 0, rb, n_rows).long(), src.expand(B, K, M))
    return GatherPlan(inv[..., :n_rows].contiguous(), None)


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


def gather_dw_plain(features: torch.Tensor, idx: torch.Tensor, hit: torch.Tensor,
                    g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the weight-gradient kernel: the zero-row
    gather and ``einsum("bmc,bmo->co")`` per tap in f32. features [B, N,
    Cin], idx / hit [B, K, M], g [B, M, Cout] -> dW [K, Cin, Cout] f32."""
    B, N, Cin = features.shape
    K, M = idx.shape[1], idx.shape[2]
    acc = _acc_dtype(features.dtype)
    tbl = torch.cat([features, features.new_zeros(B, 1, Cin)], dim=1)
    safe = torch.where(hit, idx.long(), N)
    gf = g.to(acc)
    dw = torch.empty(K, Cin, g.shape[-1], dtype=acc, device=features.device)
    for k in range(K):
        rows = torch.gather(tbl, 1, safe[:, k, :, None].expand(B, M, Cin))
        dw[k] = torch.einsum("bmc,bmo->co", rows.to(acc), gf)
    return dw


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the row gather: ``table[idx]`` for a table
    [N, C]; for [B, R, C] the rows in (batch, row) order, by advanced
    indexing on the same view (no copy of the table)."""
    i = idx.long()
    if table.dim() == 2:
        return table[i]
    R = table.shape[1]
    return table[torch.div(i, R, rounding_mode="floor"), torch.remainder(i, R)]


def _launch_gemm(features: torch.Tensor, plan: GatherPlan,
                 weights: torch.Tensor) -> torch.Tensor:
    """One launch of ``csrc/gather.cu::gather_gemm_f32`` over ``plan``:
    features [B, N, Cin] f32, weights [K, Cin, Cout] -> [B, M, Cout]. Cin is
    zero-padded to a multiple of 4 and Cout to the kernel's column tile here
    (no autograd: the callers are the Function below and the wrapper)."""
    B, N, Cin = features.shape
    K, M = plan.rulebook.shape[1], plan.rulebook.shape[2]
    Cout = weights.shape[-1]
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


class _GatherGemm(torch.autograd.Function):
    """The K4 launch with its gradients: dX by K4 over the inverse rulebook
    (skipped when the features need none, as the stem's voxel features),
    dW by ``gather_dw`` over the same plan (the features are kept only when
    the weights need it)."""

    @staticmethod
    def forward(ctx, features, weights, plan):
        ctx.plan, ctx.n_rows = plan, features.shape[1]
        ctx.save_for_backward(features if ctx.needs_input_grad[1] else None, weights)
        return _launch_gemm(features, plan, weights)

    @staticmethod
    def backward(ctx, g):
        features, weights = ctx.saved_tensors
        plan = ctx.plan
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            if plan.symmetric:  # tap k's inverse is tap K-1-k: the plan again
                dx = _launch_gemm(g, plan, weights.flip(0).transpose(1, 2))
            else:
                dx = _launch_gemm(g, inverse_plan(plan, ctx.n_rows), weights.transpose(1, 2))
        if ctx.needs_input_grad[1]:
            dw = _launch_dw(features, plan, g)
        return dx, dw, None


def gather_gemm(features: torch.Tensor, idx: torch.Tensor, hit: torch.Tensor,
                weights: torch.Tensor, plan: GatherPlan | None = None) -> torch.Tensor:
    """The fused gather-GEMM's wrapper (``ops/sparse.py::gather_gemm``
    semantics): features [B, N, Cin], idx [B, K, M] int32 in [0, N), hit
    [B, K, M] bool, weights [K, Cin, Cout] -> [B, M, Cout] in the features'
    dtype, differentiable in features and weights. ``plan`` is
    ``gather_plan(idx, hit)``, made once by a caller whose rulebook serves
    several convs; made here (rows in order, not symmetric) when not given.

    CPU tensors take the plain version. CUDA tensors (f32, the type of the
    gather engine's convs) launch ``csrc/gather.cu`` (3xTF32 on the tensor
    cores) or raise; Cin is zero-padded to a multiple of 4 and Cout to the
    kernel's column tile where needed (the stem's 5 channels; every other
    conv of the path is aligned), by autograd-tracked pads around the
    launch's Function."""
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
    if plan.symmetric and M != N:
        raise ValueError(f"gather_gemm: a symmetric plan has M == N, got M={M}, N={N}")
    if not (torch.is_grad_enabled() and (features.requires_grad or weights.requires_grad)):
        return _launch_gemm(features, plan, weights)
    Cinp, Coutp = -(-Cin // 4) * 4, _cout_pad(Cout)
    if Cinp != Cin:
        features = F.pad(features, (0, Cinp - Cin))
    if Cinp != Cin or Coutp != Cout:
        weights = F.pad(weights, (0, Coutp - Cout, 0, Cinp - Cin))
    out = _GatherGemm.apply(features.contiguous(), weights.contiguous(), plan)
    return out[..., :Cout] if Coutp != Cout else out


gather_gemm.launches = 0

def _dw_tile(c: int) -> int:
    """The dW kernel's tile along Cin or Cout: 16, 32 or 64."""
    return 16 if c <= 16 else (32 if c <= 32 else 64)


def _dw_chunk_shares(B: int, M: int, K: int, Cin: int, Cout: int) -> tuple:
    """(shares, chunks per share) of a dW launch: the B * ceil(M / 32)
    chunks of plan positions cut into equal runs, so that shares x taps x
    tiles is about ``_DW_BLOCKS`` blocks, each run at most ``DW_MAX_CHUNKS``
    chunks."""
    chunks = B * -(-M // DW_CHUNK)
    tiles = -(-Cin // _dw_tile(Cin)) * -(-Cout // _dw_tile(Cout))
    shares = max(1, min(chunks, -(-_DW_BLOCKS // (K * tiles))))
    cps = min(-(-chunks // shares), DW_MAX_CHUNKS)
    return -(-chunks // cps), cps


def _launch_dw(features: torch.Tensor, plan: GatherPlan, g: torch.Tensor) -> torch.Tensor:
    """One launch of ``csrc/gather.cu::gather_dw_f32``: features [B, N, Cin]
    f32 with Cin % 4 == 0, g [B, M, Cout] f32 with Cout % 4 == 0 -> dW [K,
    Cin, Cout]. Each block (share, tap, tile) writes one partial tile; a
    second kernel adds a tap's partials in share order, so a repeat gives
    the same bits."""
    B, N, Cin = features.shape
    K, M = plan.rulebook.shape[1], plan.rulebook.shape[2]
    Cout = g.shape[-1]
    if Cin % 4 or Cout % 4:
        raise ValueError(f"gather_dw: Cin {Cin} and Cout {Cout} must be multiples of 4")
    if B * M == 0:
        return torch.zeros(K, Cin, Cout, dtype=torch.float32, device=features.device)
    shares, cps = _dw_chunk_shares(B, M, K, Cin, Cout)
    features, g = features.contiguous(), g.contiguous()
    dw = torch.empty(K, Cin, Cout, dtype=torch.float32, device=features.device)
    part = torch.empty(shares * K * Cin * Cout, dtype=torch.float32, device=features.device)
    _build.function("gather", "gather_dw_f32", _DW_ARGS, "gather_dw")(
        features.device, features.data_ptr(), plan.rulebook.data_ptr(),
        0 if plan.order is None else plan.order.data_ptr(), g.data_ptr(), dw.data_ptr(),
        part.data_ptr(), B, N, Cin, K, M, Cout, shares, cps)
    gather_dw.launches += 1
    return dw


def gather_dw(features: torch.Tensor, idx: torch.Tensor, hit: torch.Tensor,
              g: torch.Tensor, plan: GatherPlan | None = None) -> torch.Tensor:
    """The weight-gradient kernel's wrapper: features [B, N, Cin] f32, idx /
    hit [B, K, M], g [B, M, Cout] f32 -> dW [K, Cin, Cout] f32 (the weight
    gradient of ``gather_gemm`` for an output gradient g). ``plan`` as for
    ``gather_gemm``. CPU tensors take the plain version; CUDA tensors launch
    the kernel (3xTF32 on ``mma.sync``, f32 sums) or raise; Cin and Cout are
    zero-padded to multiples of 4 where needed. ``gather_dw.launches``
    counts launches (in a train step they come from ``gather_gemm``'s
    backward)."""
    if features.device.type == "cpu":
        return gather_dw_plain(features, idx, hit, g)
    if features.device.type != "cuda":
        raise ValueError(f"gather_dw: unsupported device {features.device}")
    if features.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"gather_dw: features {features.dtype} / g {g.dtype}; the kernel "
                        "takes f32")
    B, N, Cin = features.shape
    M, Cout = idx.shape[2], g.shape[-1]
    if (idx.dtype != torch.int32 or hit.shape != idx.shape or idx.shape[0] != B
            or g.shape[:2] != (B, M)):
        raise ValueError(f"gather_dw: shapes features {tuple(features.shape)}, idx "
                         f"{tuple(idx.shape)} {idx.dtype}, hit {tuple(hit.shape)}, g "
                         f"{tuple(g.shape)}")
    if not (idx.device == hit.device == g.device == features.device):
        raise ValueError("gather_dw: inputs must be on one device")
    if plan is None:
        plan = gather_plan(idx, hit, sort=False)
    Cinp, Coutp = -(-Cin // 4) * 4, -(-Cout // 4) * 4
    if Cinp != Cin:
        features = F.pad(features, (0, Cinp - Cin))
    if Coutp != Cout:
        g = F.pad(g, (0, Coutp - Cout))
    dw = _launch_dw(features, plan, g)
    return dw[:, :Cin, :Cout] if (Cinp != Cin or Coutp != Cout) else dw


gather_dw.launches = 0


def _launch_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One launch of ``csrc/gather.cu::gather_rows`` (see ``gather_rows``)."""
    dev = table.device
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


class _GatherRows(torch.autograd.Function):
    """The K5 launch with its backward: the rows' gradients scatter-added
    (``index_add_``: a row taken twice gets both) into a zero table; an
    index outside the table's rows gets nothing."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.shape = table.shape
        return _launch_rows(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        C = ctx.shape[-1]
        rows = ctx.shape.numel() // C
        i = idx.long()
        dt = g.new_zeros(rows + 1, C)
        dt.index_add_(0, torch.where((i >= 0) & (i < rows), i, rows), g)
        return dt[:rows].view(ctx.shape), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The row gather's wrapper: table [N, C] or [B, R, C] of any strides
    (a permuted view is read where it lies), idx [M] int32 over the table's
    rows in (batch, row) order -> [M, C] contiguous in the table's dtype
    (JAX's ``gather_rows`` without its ``M % block_m == 0`` rule and its
    128-lane padding), differentiable in the table.

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
    if torch.is_grad_enabled() and table.requires_grad:
        return _GatherRows.apply(table, idx)
    return _launch_rows(table, idx)


gather_rows.launches = 0
