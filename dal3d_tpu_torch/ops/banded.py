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
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build


def _pad8(n: int) -> int:
    return ((n + 7) // 8) * 8


def banded_conv_plain(table: torch.Tensor, idx: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: masked gather + per-tap matmul in
    f32, rounded to the table's dtype (the twin of ``_banded_fwd_xla``)."""
    B, Mb, R = table.shape
    Q, M = idx.shape[1], idx.shape[2]
    tbl = torch.cat([table, table.new_zeros(B, 1, R)], dim=1)
    safe = torch.where(idx >= 0, idx, Mb).long()
    out = torch.zeros(B, M, w.shape[-1], dtype=torch.float32, device=table.device)
    for q in range(Q):
        g = torch.gather(tbl, 1, safe[:, q, :, None].expand(B, M, R))
        out += torch.matmul(g.float(), w[q].float())
    return out.to(table.dtype)


def banded_conv(table: torch.Tensor, idx: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """The kernel's wrapper: table [B, Mb, R], idx [B, Q, M] int32 (-1 = no
    contribution), w [Q, R, Rout] -> [B, M, Rout] in the table's dtype.

    CPU tensors take the plain version. CUDA tensors (bf16 or f32, every
    index below Mb, as the rulebook builders guarantee) launch
    ``csrc/banded_conv.cu`` or raise; R and Rout are zero-padded to the
    kernel's multiple of 8 where needed (the callers in ops/sparse_brick.py
    choose aligned widths, so the main path copies nothing).
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
    lib = _build.load("banded_conv")
    launch = getattr(lib, fn)
    launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    launch.restype = ctypes.c_int
    with torch.cuda.device(table.device):
        err = launch(table.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
                     B, Mb, Rp, Q, M, Routp, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "banded_conv")
    banded_conv.launches += 1
    return out[..., :Rout] if Routp != Rout else out


banded_conv.launches = 0


def banded_gather_matmul(table: torch.Tensor, wband: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """Full banded op over a full rulebook (JAX's argument order): table
    [B, Mb, R], wband [Q, R, Rout] (cast to the table's dtype), idx
    [B, Q, M] (-1 = miss) -> [B, M, Rout]."""
    return banded_conv(table, idx.to(torch.int32), wband.to(table.dtype))
