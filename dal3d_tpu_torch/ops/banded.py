"""Rulebook gather-GEMM of the brick sparse-conv engine (port of
``dal3d_tpu/ops/banded.py``).

    out[b, m] = sum_{q : idx[b, q, m] >= 0} table[b, idx[b, q, m]] @ w[q]

Every subm halo-pad, subm conv, strided pad and strided conv of the banded
backbone is one call of this op. The TPU version splits each rulebook into an
in-band part (a one-hot MXU gather over a DMA'd slab, ``_fwd_kernel``) and an
out-of-band fallback applied by XLA (``apply_fallback``). Hopper gathers rows
straight from device memory, so the port's kernel (``csrc/banded_conv.cu``)
takes the full rulebook (``where(hit, idx, -1)``): there is no band plan, no
``starts`` and no fallback. Results equal JAX's wherever JAX's plan covers
every out-of-band entry (``fb_covered == oob_count``); in f32 up to the
summation order, in bf16 up to where the two round (JAX rounds the in-band
sum to bf16 before adding the fallback; the port rounds once).

The op carries gradients (``torch.autograd.Function`` with the semantics of
JAX's ``_banded_conv_bwd``): the incoming gradient is rounded to the table's
dtype; the weight gradient is a second hand-written kernel
(``csrc/banded_dw.cu``, the port of ``_dw_kernel``), f32 sums rounded to the
weight's dtype; the input gradient of a tap-symmetric rulebook is the forward
kernel again on the gradient with the taps reversed and each weight
transposed, and of any other rulebook a per-tap matmul + ``index_add_`` in
f32 (the counterpart of JAX's XLA scatter-add, which is no Pallas kernel).
The caller says which (``symmetric``); nothing is detected at run time.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build


def _pad8(n: int) -> int:
    return ((n + 7) // 8) * 8


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 sums for bf16 / f32 inputs (f64 stays f64, for gradcheck)."""
    return torch.promote_types(dtype, torch.float32)


def _gather_tap(tbl: torch.Tensor, safe: torch.Tensor, q: int) -> torch.Tensor:
    """Rows of the zero-extended table [B, Mb+1, R] for tap q -> [B, M, R]."""
    B, _, R = tbl.shape
    return torch.gather(tbl, 1, safe[:, q, :, None].expand(B, safe.shape[2], R))


# (rows, columns) of the weight blocks whose zeros the forward kernel skips
# (FLAG_BK, FLAG_BN of csrc/banded_conv.cu)
BAND_BLOCK = (32, 64)


def band_block_mask(w: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward kernel's skip flags: w [Q, R, Rout] ->
    [Q, ceil(R / bk), ceil(Rout / bn)] bool for (bk, bn) = BAND_BLOCK, True
    where the block holds a nonzero (-0 counts as zero)."""
    bk, bn = BAND_BLOCK
    Q, R, Rout = w.shape
    nkb, nnb = -(-R // bk), -(-Rout // bn)
    nz = F.pad(w != 0, (0, nnb * bn - Rout, 0, nkb * bk - R))
    return nz.view(Q, nkb, bk, nnb, bn).any(4).any(2)


def banded_conv_plain(table: torch.Tensor, idx: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: masked gather + per-tap matmul in
    f32, rounded to the table's dtype (the twin of ``_banded_fwd_xla``)."""
    B, Mb, R = table.shape
    Q, M = idx.shape[1], idx.shape[2]
    acc = _acc_dtype(table.dtype)
    tbl = torch.cat([table, table.new_zeros(B, 1, R)], dim=1)
    safe = torch.where(idx >= 0, idx, Mb).long()
    out = torch.zeros(B, M, w.shape[-1], dtype=acc, device=table.device)
    for q in range(Q):
        out += torch.matmul(_gather_tap(tbl, safe, q).to(acc), w[q].to(acc))
    return out.to(table.dtype)


def banded_dw_plain(table: torch.Tensor, idx: torch.Tensor,
                    g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the weight-gradient kernel: masked gather +
    ``einsum("bmr,bmo->ro")`` per tap in f32 (the twin of the XLA branch of
    ``_banded_conv_bwd``). table [B, Mb, R], idx [B, Q, M], g [B, M, Rout]
    -> dw [Q, R, Rout] f32."""
    B, Mb, R = table.shape
    Q = idx.shape[1]
    acc = _acc_dtype(table.dtype)
    tbl = torch.cat([table, table.new_zeros(B, 1, R)], dim=1)
    safe = torch.where(idx >= 0, idx, Mb).long()
    gf = g.to(acc)
    dw = torch.empty(Q, R, g.shape[-1], dtype=acc, device=table.device)
    for q in range(Q):
        dw[q] = torch.einsum("bmr,bmo->ro", _gather_tap(tbl, safe, q).to(acc), gf)
    return dw


def banded_dtable_scatter(g: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                          Mb: int) -> torch.Tensor:
    """Input gradient of a rulebook that is not tap-symmetric:
    dtable[b, idx[b, q, m]] += g[b, m] @ w[q]^T over the hits. Each tap's
    product is rounded to g's dtype and added into an f32 buffer with
    ``index_add_``, as JAX's XLA scatter-add branch does. g [B, M, Rout], w
    [Q, R, Rout] -> [B, Mb, R] in g's dtype."""
    B, M, _ = g.shape
    Q, R = w.shape[0], w.shape[1]
    acc = _acc_dtype(g.dtype)
    buf = torch.zeros(B * (Mb + 1), R, dtype=acc, device=g.device)
    base = (torch.arange(B, device=g.device) * (Mb + 1))[:, None]
    for q in range(Q):
        gw = torch.matmul(g, w[q].to(g.dtype).transpose(0, 1))  # f32 sums, g's dtype
        rows = torch.where(idx[:, q] >= 0, idx[:, q].long(), Mb) + base
        buf.index_add_(0, rows.reshape(-1), gw.reshape(B * M, R).to(acc))
    return buf.view(B, Mb + 1, R)[:, :Mb].to(g.dtype)


def banded_conv(table: torch.Tensor, idx: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """The kernel's wrapper: table [B, Mb, R], idx [B, Q, M] int32 (-1 = no
    contribution), w [Q, R, Rout] -> [B, M, Rout] in the table's dtype.

    CPU tensors take the plain version. CUDA tensors (bf16 or f32, every
    index below Mb, as the rulebook builders guarantee) launch
    ``csrc/banded_conv.cu`` or raise; R and Rout are zero-padded to the
    kernel's multiple of 8 where needed (the callers in ops/sparse_brick.py
    choose aligned widths, so the main path copies nothing). The kernel
    skips the ``BAND_BLOCK`` blocks of w that hold only zeros (see
    ``band_block_mask``): exact for a finite table.
    ``banded_conv.launches`` counts kernel launches."""
    if table.device.type == "cpu":
        return banded_conv_plain(table, idx, w)
    if table.device.type != "cuda":
        raise ValueError(f"banded_conv: unsupported device {table.device}")
    B, Mb, R = table.shape
    Q, M = idx.shape[1], idx.shape[2]
    Rout = w.shape[-1]
    fn = {torch.bfloat16: "banded_conv_bf16", torch.float32: "banded_conv_f32"}.get(table.dtype)
    if fn is None or w.dtype != table.dtype:
        raise TypeError(f"banded_conv: table {table.dtype} / w {w.dtype}; "
                        "the kernel takes bf16 or f32, both the same")
    if idx.dtype != torch.int32 or idx.shape[0] != B or w.shape[:2] != (Q, R):
        raise ValueError(f"banded_conv: shapes table {tuple(table.shape)}, "
                         f"idx {tuple(idx.shape)} {idx.dtype}, w {tuple(w.shape)}")
    if idx.device != table.device or w.device != table.device:
        raise ValueError("banded_conv: inputs must be on one device")
    Rp, Routp = _pad8(R), _pad8(Rout)
    if Rp != R:
        table = F.pad(table, (0, Rp - R))
    if Rp != R or Routp != Rout:
        w = F.pad(w, (0, Routp - Rout, 0, Rp - R))
    table, idx, w = table.contiguous(), idx.contiguous(), w.contiguous()
    out = torch.empty(B, M, Routp, dtype=table.dtype, device=table.device)
    # the kernel's skip flags: one int per 32 x 64 block of each w[q]
    flags = torch.empty(Q * -(-Rp // BAND_BLOCK[0]) * -(-Routp // BAND_BLOCK[1]),
                        dtype=torch.int32, device=table.device)
    _build.function("banded_conv", fn, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6,
                    "banded_conv")(table.device, table.data_ptr(), idx.data_ptr(), w.data_ptr(),
                                   flags.data_ptr(), out.data_ptr(), B, Mb, Rp, Q, M, Routp)
    banded_conv.launches += 1
    return out[..., :Rout] if Routp != Rout else out


banded_conv.launches = 0

# the dw tile (rows of R, columns of Rout) of each kernel of csrc/banded_dw.cu
# and the blocks of it one multiprocessor holds at once
_DW_TILE = {torch.bfloat16: (128, 256), torch.float32: (64, 64)}
_DW_RESIDENT = {torch.bfloat16: 1, torch.float32: 4}
# the kernel's scratch ints after the partial tiles (hit counts, share ranges)
_DW_SCRATCH_INTS = 640
_DW_MIN_SHARE = 4096  # (row, tap) pairs per share at least


def _dw_shares(tiles: int, rows: int, taps: int, slots: int) -> int:
    """Equal shares of the hits (blocks per dw tile) for a weight-gradient
    launch of ``tiles`` dw tiles on a card that holds ``slots`` blocks at
    once: one full wave and not a block more (the shares are equal, so a
    second wave of a few blocks would double the time), each share over at
    least ``_DW_MIN_SHARE`` (row, tap) pairs."""
    return max(1, min(slots // tiles, rows * taps // _DW_MIN_SHARE))


def banded_dw(table: torch.Tensor, idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The weight-gradient kernel's wrapper: table [B, Mb, R], idx [B, Q, M]
    int32 (-1 = no contribution), g [B, M, Rout] in the table's dtype ->
    dw [Q, R, Rout] f32, dw[q] = sum_{b, m} table[b, idx[b, q, m]]^T g[b, m].

    CPU tensors take the plain version. CUDA tensors (bf16 or f32) launch
    ``csrc/banded_dw.cu`` or raise; R and Rout are zero-padded to the kernel's
    multiple of 8 where needed. The hits of all taps are cut into equal
    shares, one block per (dw tile, share), each of which multiplies only
    hit rows; a last kernel adds each tap's partial sums in share order
    (deterministic: the same bits on every call). At most 64 taps.
    ``banded_dw.launches`` counts launches."""
    if table.device.type == "cpu":
        return banded_dw_plain(table, idx, g)
    if table.device.type != "cuda":
        raise ValueError(f"banded_dw: unsupported device {table.device}")
    B, Mb, R = table.shape
    Q, M = idx.shape[1], idx.shape[2]
    Rout = g.shape[-1]
    fn = {torch.bfloat16: "banded_dw_bf16", torch.float32: "banded_dw_f32"}.get(table.dtype)
    if fn is None or g.dtype != table.dtype:
        raise TypeError(f"banded_dw: table {table.dtype} / g {g.dtype}; "
                        "the kernel takes bf16 or f32, both the same")
    if idx.dtype != torch.int32 or idx.shape[0] != B or g.shape[:2] != (B, M):
        raise ValueError(f"banded_dw: shapes table {tuple(table.shape)}, "
                         f"idx {tuple(idx.shape)} {idx.dtype}, g {tuple(g.shape)}")
    if idx.device != table.device or g.device != table.device:
        raise ValueError("banded_dw: inputs must be on one device")
    Rp, Routp = _pad8(R), _pad8(Rout)
    if Rp != R:
        table = F.pad(table, (0, Rp - R))
    if Routp != Rout:
        g = F.pad(g, (0, Routp - Rout))
    table, idx, g = table.contiguous(), idx.contiguous(), g.contiguous()
    if Q > 64:
        raise ValueError(f"banded_dw: the kernel takes at most 64 taps, got {Q}")
    tr, to = _DW_TILE[table.dtype]
    sms = torch.cuda.get_device_properties(table.device).multi_processor_count
    shares = _dw_shares(-(-Rp // tr) * -(-Routp // to), B * M, Q, sms * _DW_RESIDENT[table.dtype])
    dw = torch.empty(Q, Rp, Routp, dtype=torch.float32, device=table.device)
    # partial tiles (shares + Q - 1 of them) and the kernel's ints
    part = torch.empty((shares + Q - 1) * Rp * Routp + _DW_SCRATCH_INTS, dtype=torch.float32,
                       device=table.device)
    _build.function("banded_dw", fn, [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7, "banded_dw")(
        table.device, table.data_ptr(), idx.data_ptr(), g.data_ptr(), dw.data_ptr(),
        part.data_ptr(), B, Mb, Rp, Q, M, Routp, shares)
    banded_dw.launches += 1
    return dw[:, :R, :Rout] if (Rp != R or Routp != Rout) else dw


banded_dw.launches = 0


class _BandedConv(torch.autograd.Function):
    """``banded_conv`` with the gradients of JAX's ``_banded_conv_bwd``. Work
    the graph does not ask for is skipped: a constant weight launches no
    weight-gradient kernel (and keeps no table), a table without a gradient
    gets no input gradient."""

    @staticmethod
    def forward(ctx, table, idx, w, symmetric):
        ctx.symmetric = symmetric
        ctx.mb = table.shape[1]
        ctx.save_for_backward(table if ctx.needs_input_grad[2] else None, idx, w)
        return banded_conv(table, idx, w)

    @staticmethod
    def backward(ctx, g):
        table, idx, w = ctx.saved_tensors
        g = g.to(w.dtype).contiguous()
        dtable = dw = None
        if ctx.needs_input_grad[0]:
            if ctx.symmetric:
                # the dual gather: same rulebook, taps reversed, weights transposed
                dtable = banded_conv(g, idx, w.flip(0).transpose(1, 2).contiguous())
            else:
                dtable = banded_dtable_scatter(g, idx, w, ctx.mb)
        if ctx.needs_input_grad[2]:
            dw = banded_dw(table, idx, g).to(w.dtype)
        return dtable, None, dw, None


def banded_gather_matmul(table: torch.Tensor, wband: torch.Tensor,
                         idx: torch.Tensor, symmetric: bool = False) -> torch.Tensor:
    """Full banded op over a full rulebook (JAX's argument order): table
    [B, Mb, R], wband [Q, R, Rout] (cast to the table's dtype), idx
    [B, Q, M] (-1 = miss) -> [B, M, Rout]; differentiable in table and wband.

    ``symmetric`` states that the rulebook is tap-symmetric (M == Mb and
    ``idx[b, Q-1-q, idx[b, q, m]] == m`` on every hit), which routes the input
    gradient through the forward kernel; say False for any other rulebook."""
    if symmetric and idx.shape[2] != table.shape[1]:
        raise ValueError(f"banded_gather_matmul: a symmetric rulebook has M == Mb, got "
                         f"M={idx.shape[2]}, Mb={table.shape[1]}")
    return _BandedConv.apply(table, idx.to(torch.int32), wband.to(table.dtype), symmetric)
