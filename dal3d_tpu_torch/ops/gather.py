"""Fused gather-GEMM and row gather of the gather sparse-conv engine (port of
``dal3d_tpu/ops/pallas_gather.py``).

    gather_gemm:  out[b, m] = sum_k hit[b, k, m] * features[b, idx[b, k, m]] @ W[k]
    gather_rows:  out[m] = table[idx[m]]

``gather_gemm`` is the compute of every convolution of the gather engine
(``ops/sparse_grid.py``), so of every conv of BEVFusion's SparseEncoder;
``gather_rows`` is TransFusion's query gather. Each wrapper runs its plain
PyTorch version for a CPU tensor and launches its CUDA kernel
(``csrc/gather.cu``) for a CUDA tensor, or raises; ``<wrapper>.launches``
counts the kernel launches.

The grid engine hands over JAX's rulebook form, ``max(idx, 0)`` with a
separate ``hit``; the wrapper folds the two into one rulebook with -1 for a
miss, which the kernel turns into a zero-filled row: a miss adds exactly 0.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .banded import _acc_dtype


def _cout_pad(cout: int) -> int:
    """The kernel's column tiles: 16, 32, 64, or a multiple of 128."""
    for c in (16, 32, 64):
        if cout <= c:
            return c
    return -(-cout // 128) * 128


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
    """Plain PyTorch version of the row gather: ``table[idx]``."""
    return table[idx.long()]


def gather_gemm(features: torch.Tensor, idx: torch.Tensor, hit: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """The fused gather-GEMM's wrapper (``ops/sparse.py::gather_gemm``
    semantics): features [B, N, Cin], idx [B, K, M] int32 in [0, N), hit
    [B, K, M] bool, weights [K, Cin, Cout] -> [B, M, Cout] in the features'
    dtype.

    CPU tensors take the plain version. CUDA tensors (f32, the type of the
    gather engine's convs) launch ``csrc/gather.cu`` or raise; Cin is
    zero-padded to a multiple of 4 and Cout to the kernel's column tile where
    needed (the stem's 5 channels; every other conv of the path is aligned)."""
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
    Cinp, Coutp = -(-Cin // 4) * 4, _cout_pad(Cout)
    if Cinp != Cin:
        features = F.pad(features, (0, Cinp - Cin))
    if Cinp != Cin or Coutp != Cout:
        weights = F.pad(weights, (0, Coutp - Cout, 0, Cinp - Cin))
    rulebook = torch.where(hit, idx, -1).contiguous()
    features, weights = features.contiguous(), weights.contiguous()
    out = torch.empty(B, M, Coutp, dtype=torch.float32, device=features.device)
    lib = _build.load("gather")
    launch = lib.gather_gemm_f32
    launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    launch.restype = ctypes.c_int
    with torch.cuda.device(features.device):
        err = launch(features.data_ptr(), rulebook.data_ptr(), weights.data_ptr(),
                     out.data_ptr(), B, N, Cinp, K, M, Coutp,
                     torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "gather_gemm")
    gather_gemm.launches += 1
    return out[..., :Cout] if Coutp != Cout else out


gather_gemm.launches = 0


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The row gather's wrapper: table [N, C], idx [M] int32 in [0, N) ->
    [M, C] in the table's dtype (JAX's ``gather_rows`` without its
    ``M % block_m == 0`` rule and its 128-lane padding).

    CPU tensors take the plain version. CUDA tensors launch
    ``csrc/gather.cu`` or raise; there an index outside [0, N) gives a zero
    row."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {table.device}")
    if table.dim() != 2 or idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"gather_rows: table {tuple(table.shape)}, idx {tuple(idx.shape)} "
                         f"{idx.dtype}; expected [N, C] and [M] int32")
    if idx.device != table.device:
        raise ValueError("gather_rows: inputs must be on one device")
    N, C = table.shape
    M = idx.shape[0]
    table, idx = table.contiguous(), idx.contiguous()
    out = torch.empty(M, C, dtype=table.dtype, device=table.device)
    lib = _build.load("gather")
    launch = lib.gather_rows
    launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_longlong,
                                                                    ctypes.c_void_p]
    launch.restype = ctypes.c_int
    with torch.cuda.device(table.device):
        err = launch(table.data_ptr(), idx.data_ptr(), out.data_ptr(), N, M,
                     C * table.element_size(), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
