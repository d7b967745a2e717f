"""Fused gather-GEMM and row gather of the gather sparse-conv engine (port of
``dal3d_tpu/ops/pallas_gather.py``), with their gradients.

    gather_gemm:  out[b, m] = sum_k hit[b, k, m] * features[b, idx[b, k, m]] @ W[k]
    gather_rows:  out[m] = rows(table)[idx[m]]
    gather_dw:    dW[k] = sum_{b, m} hit[b, k, m] * features[b, idx[b, k, m]]^T g[b, m]

``gather_gemm`` is the compute of every convolution of the gather engine
(``ops/sparse_grid.py``), so of every conv of BEVFusion's SparseEncoder;
``gather_rows`` is TransFusion's query gather. Each wrapper runs its plain
PyTorch version for a CPU tensor and launches its CUDA kernel
(``csrc/gather.cu``) for a CUDA tensor, or raises. ``gather_gemm`` and
``gather_dw`` take f32 or bf16 (the backbone's ``dtype``), each type its own
kernel: ``<wrapper>.launches`` counts the f32 kernel's launches,
``gather_gemm_bf16.launches`` and ``gather_dw_bf16.launches`` the bf16
kernels'; ``gather_rows.launches`` counts K5's.

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
DW_CHUNK = 32  # plan positions of one reduction step of the f32 dW kernel
DW_BF16_CHUNK = 64  # ... of the bf16 one (one ring stage: four k16 steps)
DW_MAX_CHUNKS = 256  # chunks of one share (the kernel's shared-memory list)
_SMS = 132  # multiprocessors of an H100
_DW_WAVES = 8  # a dW launch's blocks: this many times what the card holds at once
_DW_BF16_WAVES = 4  # ... of the bf16 kernel, whose blocks each stream a longer share


class LaunchCount:
    """The launch count of a kernel that a wrapper of another name reaches
    (``gather_gemm`` launches the bf16 K4 for bf16 tensors): ``launches``,
    and the kernel's name as ``__name__``, as a wrapper's own count has."""

    def __init__(self, name: str):
        self.__name__, self.launches = name, 0


gather_gemm_bf16 = LaunchCount("gather_gemm_bf16")
gather_dw_bf16 = LaunchCount("gather_dw_bf16")
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _chan_pad(c: int, dtype: torch.dtype) -> int:
    """A channel count of a K4 or K4-dW launch: a multiple of 4 (f32: 16
    bytes) or 16 (bf16: the depth of one bf16 product)."""
    q = 16 if dtype == torch.bfloat16 else 4
    return -(-c // q) * q


def _cout_pad(cout: int) -> int:
    """The kernel's column tiles: 16, 32, 64, or a multiple of 128."""
    for c in (16, 32, 64):
        if cout <= c:
            return c
    return -(-cout // 128) * 128


def gemm_tile_rows(cout: int, bf16: bool = False) -> tuple:
    """(plan positions of a block, rows of a group that skips a tap
    together) of the kernel for this Cout (csrc/gather.cu). f32: 128-row
    blocks of 8 warps' groups of 16 below 64, of 4 groups of 32 from 64 on.
    bf16: a warpgroup's 64 rows (wgmma's M), blocks of two warpgroups at
    Cout 64 and of one otherwise (held to ``built_bf16_tile`` on the card)."""
    if bf16:
        return (128 if _cout_pad(cout) == 64 else 64), 64
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
def gemm_walk(plan: GatherPlan, cout: int, bf16: bool = False):
    """The walk of the f32 or the bf16 kernel over a plan, for one column
    tile: (tap masks of its blocks [B, T, K], of their row groups [B, T * G,
    K]). A block steps through the taps its rows hit; a row group stages and
    multiplies only the taps its own rows hit."""
    B, K, M = plan.rulebook.shape
    bm, wr = gemm_tile_rows(cout, bf16)
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
    """Plain PyTorch version of the weight-gradient kernels: the zero-row
    gather and ``einsum("bmc,bmo->co")`` per tap in f32, rounded to the
    features' dtype (bf16 dW for bf16 operands, as autograd of
    ``gather_gemm_plain`` gives it). features [B, N, Cin], idx / hit [B, K,
    M], g [B, M, Cout] -> dW [K, Cin, Cout]."""
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
    return dw.to(features.dtype)


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
    """One launch of ``csrc/gather.cu::gather_gemm_f32`` (f32) or
    ``gather_gemm_bf16`` (bf16) over ``plan``: features [B, N, Cin] and
    weights [K, Cin, Cout] of that type -> [B, M, Cout] of it. Cin is
    zero-padded to ``_chan_pad`` and Cout to the kernel's column tile here
    (no autograd: the callers are the Function below and the wrapper)."""
    B, N, Cin = features.shape
    K, M = plan.rulebook.shape[1], plan.rulebook.shape[2]
    Cout = weights.shape[-1]
    bf16 = features.dtype == torch.bfloat16
    Cinp, Coutp = _chan_pad(Cin, features.dtype), _cout_pad(Cout)
    if Cinp != Cin:
        features = F.pad(features, (0, Cinp - Cin))
    if Cinp != Cin or Coutp != Cout:
        weights = F.pad(weights, (0, Coutp - Cout, 0, Cinp - Cin))
    features, weights = features.contiguous(), weights.contiguous()
    out = torch.empty(B, M, Coutp, dtype=features.dtype, device=features.device)
    fn = "gather_gemm_bf16" if bf16 else "gather_gemm_f32"
    _build.function("gather", fn, _GEMM_ARGS, "gather_gemm")(
        features.device, features.data_ptr(), plan.rulebook.data_ptr(),
        0 if plan.order is None else plan.order.data_ptr(),
        weights.data_ptr(), out.data_ptr(), B, N, Cinp, K, M, Coutp)
    (gather_gemm_bf16 if bf16 else gather_gemm).launches += 1
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

    CPU tensors take the plain version. CUDA tensors launch
    ``csrc/gather.cu`` or raise: f32 features and weights the f32 kernel
    (3xTF32 on the tensor cores), bf16 ones the bf16 kernel (bf16 products,
    f32 sums, the output rounded once, as JAX's); any other type, or two
    types, raises. Cin is zero-padded to a multiple of 4 (f32) or 16 (bf16)
    and Cout to the kernel's column tile where needed (the stem's 5
    channels; every other conv of the path is aligned), by autograd-tracked
    pads around the launch's Function."""
    if features.device.type == "cpu":
        return gather_gemm_plain(features, idx, hit, weights)
    if features.dtype not in _KERNEL_DTYPES or weights.dtype != features.dtype:
        raise TypeError(f"gather_gemm: features {features.dtype} / weights {weights.dtype}; "
                        "the kernels take f32 or bf16, both operands of one type")
    if features.device.type != "cuda":
        raise ValueError(f"gather_gemm: unsupported device {features.device}")
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
    Cinp, Coutp = _chan_pad(Cin, features.dtype), _cout_pad(Cout)
    if Cinp != Cin:
        features = F.pad(features, (0, Cinp - Cin))
    if Cinp != Cin or Coutp != Cout:
        weights = F.pad(weights, (0, Coutp - Cout, 0, Cinp - Cin))
    out = _GatherGemm.apply(features.contiguous(), weights.contiguous(), plan)
    return out[..., :Cout] if Coutp != Cout else out


gather_gemm.launches = 0

def _dw_tiles(Cin: int, Cout: int) -> tuple:
    """The dW kernel's tile of dW (csrc/gather.cu ``DwTile``): TI rows of
    Cin (16, 32, 64 or 128; two warpgroups of wgmma's 64 rows at 128) by TO
    columns of Cout (16, 32, 64 or 128)."""
    ti = next((c for c in (16, 32, 64) if Cin <= c), 128)
    to = next((c for c in (16, 32, 64) if Cout <= c), 128)
    return ti, to


def _dw_blocks_per_sm(ti: int, to: int) -> int:
    """Blocks of one tile shape a multiprocessor holds (csrc/gather.cu
    ``DwTile``): shared memory ``SMEM`` (two buffers of B's big and small
    planes, four ring stages of gathered features and g, 1 KB of alignment
    slack) + ``DW_STATIC`` (the chunk list, the index ring) + the 1 KB the
    card reserves, within 2048 threads."""
    smem = 1024 + 2 * 2 * to * 128 + 4 * DW_CHUNK * (ti + 4 + to) * 4
    threads = 128 * (2 if ti == 128 else 1) * (2 if ti <= 64 and to >= 64 else 1)
    fixed = DW_MAX_CHUNKS * 8 + 8 * DW_CHUNK * 12 + 16 + 1024
    return max(1, min(2048 // threads, 232448 // (smem + fixed)))


def _dw_bf16_blocks_per_sm(ti: int, to: int) -> int:
    """Blocks of one tile shape of the bf16 dW kernel a multiprocessor holds
    (csrc/gather.cu ``DwWgTile::MIN_BLOCKS``, its launch bound; the ring is
    sized to fill the shared memory of that many): the larger of (ti, to)
    is wgmma's M side in warpgroups of 64, the other its N side; a consumer
    thread holds N / 2 sums and N / 2 products, and about 40 registers
    more, within 1 to 4 blocks (held to ``built_bf16_tile`` on the card)."""
    md, nd = (to, ti) if to > ti else (ti, to)
    threads = 128 * ((2 if md > 64 else 1) + 1)
    regs = -(-(nd + 40) // 8) * 8
    return max(1, min(4, 65536 // (threads * regs)))


def built_bf16_tile(what: int, a: int, b: int = 0) -> int:
    """A tile constant of the bf16 kernels as ``csrc/gather.cu`` was built
    (``gather_bf16_tile``; builds the library on first use, so it needs the
    card's toolchain): 0, a K4 block's plan positions at Cout ``a``; 1, the
    rows of it that skip a tap together; 2, the K4-dW blocks a
    multiprocessor holds at the tile ``a`` x ``b``; -1 for a shape without a
    tile. ``gemm_tile_rows(cout, True)`` and ``_dw_bf16_blocks_per_sm``
    mirror these, and are held to them on the card."""
    fn = _build.load("gather").gather_bf16_tile
    fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    return int(fn(what, a, b))


def _dw_chunk_shares(B: int, M: int, K: int, Cin: int, Cout: int,
                     bf16: bool = False) -> tuple:
    """(shares, chunks per share) of a dW launch: the B * ceil(M / chunk)
    chunks of plan positions (``DW_CHUNK`` for f32, ``DW_BF16_CHUNK`` for
    bf16) cut into equal runs, so that shares x taps x tiles is about
    ``_DW_WAVES`` (f32) or ``_DW_BF16_WAVES`` (bf16) times the blocks the
    card holds at once (of that kernel, by tile), each run at most
    ``DW_MAX_CHUNKS`` chunks."""
    chunks = B * -(-M // (DW_BF16_CHUNK if bf16 else DW_CHUNK))
    ti, to = _dw_tiles(Cin, Cout)
    tiles = -(-Cin // ti) * -(-Cout // to)
    per_sm = _dw_bf16_blocks_per_sm(ti, to) if bf16 else _dw_blocks_per_sm(ti, to)
    blocks = (_DW_BF16_WAVES if bf16 else _DW_WAVES) * _SMS * per_sm
    shares = max(1, min(chunks, -(-blocks // (K * tiles))))
    cps = min(-(-chunks // shares), DW_MAX_CHUNKS)
    return -(-chunks // cps), cps


def _launch_dw(features: torch.Tensor, plan: GatherPlan, g: torch.Tensor) -> torch.Tensor:
    """One launch of ``csrc/gather.cu::gather_dw_f32`` (f32) or
    ``gather_dw_bf16`` (bf16): features [B, N, Cin] and g [B, M, Cout] of
    one type, Cin and Cout padded by ``_chan_pad`` -> dW [K, Cin, Cout]
    of that type (f32 sums either way). Each block (share, tap, tile) writes
    one partial tile in f32; a second kernel adds a tap's partials in share
    order and rounds once, so a repeat gives the same bits."""
    B, N, Cin = features.shape
    K, M = plan.rulebook.shape[1], plan.rulebook.shape[2]
    Cout = g.shape[-1]
    bf16 = features.dtype == torch.bfloat16
    if _chan_pad(Cin, features.dtype) != Cin or _chan_pad(Cout, features.dtype) != Cout:
        raise ValueError(f"gather_dw: Cin {Cin} and Cout {Cout} must be multiples of "
                         f"{_chan_pad(1, features.dtype)} for {features.dtype}")
    if B * M == 0:
        return torch.zeros(K, Cin, Cout, dtype=features.dtype, device=features.device)
    shares, cps = _dw_chunk_shares(B, M, K, Cin, Cout, bf16)
    features, g = features.contiguous(), g.contiguous()
    dw = torch.empty(K, Cin, Cout, dtype=features.dtype, device=features.device)
    part = torch.empty(shares * K * Cin * Cout, dtype=torch.float32, device=features.device)
    _build.function("gather", "gather_dw_bf16" if bf16 else "gather_dw_f32", _DW_ARGS,
                    "gather_dw")(
        features.device, features.data_ptr(), plan.rulebook.data_ptr(),
        0 if plan.order is None else plan.order.data_ptr(), g.data_ptr(), dw.data_ptr(),
        part.data_ptr(), B, N, Cin, K, M, Cout, shares, cps)
    (gather_dw_bf16 if bf16 else gather_dw).launches += 1
    return dw


def gather_dw(features: torch.Tensor, idx: torch.Tensor, hit: torch.Tensor,
              g: torch.Tensor, plan: GatherPlan | None = None) -> torch.Tensor:
    """The weight-gradient kernels' wrapper: features [B, N, Cin], idx / hit
    [B, K, M], g [B, M, Cout], f32 or bf16 both -> dW [K, Cin, Cout] of
    their type (the weight gradient of ``gather_gemm`` for an output
    gradient g). ``plan`` as for ``gather_gemm``. CPU tensors take the plain
    version; CUDA tensors launch the f32 kernel (3xTF32 on TF32 ``wgmma``,
    f32 sums) or the bf16 one (bf16 ``wgmma``, f32 sums, dW rounded once)
    or raise; Cin and Cout are zero-padded by ``_chan_pad`` where needed.
    ``gather_dw.launches`` and ``gather_dw_bf16.launches`` count launches
    (in a train step they come from ``gather_gemm``'s backward)."""
    if features.device.type == "cpu":
        return gather_dw_plain(features, idx, hit, g)
    if features.dtype not in _KERNEL_DTYPES or g.dtype != features.dtype:
        raise TypeError(f"gather_dw: features {features.dtype} / g {g.dtype}; the kernels "
                        "take f32 or bf16, both operands of one type")
    if features.device.type != "cuda":
        raise ValueError(f"gather_dw: unsupported device {features.device}")
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
    Cinp, Coutp = _chan_pad(Cin, features.dtype), _chan_pad(Cout, features.dtype)
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
