"""Pairwise L1 / L2 distances between frame embeddings (port of
``dal3d_tpu/ops/distance.py``; the kernels replace
``dal3d_tpu/ops/pallas_distance.py``).

The frame-distance matrix is the selectors' hot loop: ``feature_map`` needs
[N, N], a prior selection's ``init_fps`` [S, N], and every pick of the
streaming k-center one [1, N] row. On a CUDA tensor ``pairwise_l1`` /
``pairwise_l2`` launch the hand-written kernels of
``csrc/pairwise_distance.cu`` (L1, and L2 rows for at most 8 x rows) and
``csrc/pairwise_l2_tf32.cu`` (L2 matrices, 3xTF32 on the tensor cores); on a
CPU tensor they run the plain PyTorch versions below, which repeat the
kernels' arithmetic (L1 by row-blocked broadcasting, L2 by the Gram
expression |x|^2 + |y|^2 - 2 x.y).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# the plain L1 keeps its [rows, M, C] intermediate under this many floats
_PLAIN_L1_FLOATS = 1 << 26
# csrc/pairwise_distance.cu::ROW_MAX_N: an L2 call with at most this many x
# rows goes to the row kernel, a larger one to the tensor-core kernel
_ROW_MAX_N = 8
# csrc/pairwise_l2_tf32.cu::BK: the pre-pass pads C to a multiple of this
_K_TILE = 32


def pairwise_l1_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x [N, C], y [M, C] -> [N, M] L1 distances, row-blocked so that the
    broadcast intermediate stays small (the block is sized from M * C)."""
    N, M, C = x.shape[0], y.shape[0], x.shape[1]
    block = max(1, _PLAIN_L1_FLOATS // max(M * C, 1))
    out = torch.empty(N, M, dtype=x.dtype, device=x.device)
    for i in range(0, N, block):
        out[i:i + block] = (x[i:i + block, None, :] - y[None, :, :]).abs().sum(-1)
    return out


def pairwise_l2_plain(x: torch.Tensor, y: torch.Tensor, squared: bool = False) -> torch.Tensor:
    """x [N, C], y [M, C] -> [N, M] Euclidean distances by the Gram
    expression (d(x, x) is the square root of rounding noise, not 0)."""
    xx = (x * x).sum(1)[:, None]
    yy = (y * y).sum(1)[None, :]
    d2 = torch.clamp(xx + yy - 2.0 * (x @ y.T), min=0.0)
    return d2 if squared else torch.sqrt(d2)


def _check(name: str, x: torch.Tensor, y: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if (x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]
            or x.dtype != torch.float32 or y.dtype != torch.float32):
        raise ValueError(f"{name}: needs f32 x [N, C] and y [M, C], got "
                         f"{tuple(x.shape)} {x.dtype} / {tuple(y.shape)} {y.dtype}")
    if y.device != x.device:
        raise ValueError(f"{name}: inputs must be on one device")


def _launch(name: str, fn: str, x: torch.Tensor, y: torch.Tensor, extra=()) -> torch.Tensor:
    _check(name, x, y)
    # float4 loads where the bases are 16-byte aligned; the kernels decide
    x, y = x.contiguous(), y.contiguous()
    N, C = x.shape
    M = y.shape[0]
    out = torch.empty(N, M, dtype=torch.float32, device=x.device)
    _build.function("pairwise_distance", fn,
                    [ctypes.c_void_p] * 3 + [ctypes.c_int] * (3 + len(extra)), name)(
        x.device, x.data_ptr(), y.data_ptr(), out.data_ptr(), N, M, C, *extra)
    return out


def l2_split(x: torch.Tensor, cp: int) -> tuple:
    """The L2 pre-pass on the card (``pairwise_l2_split_f32``): x [rows, C]
    of any strides -> (squared norms [rows], TF32 planes big and small
    [rows, cp] as f32, C zero-padded to cp). Part of every L2 matrix launch."""
    rows, C = x.shape
    norm = torch.empty(rows, dtype=torch.float32, device=x.device)
    big = torch.empty(rows, cp, dtype=torch.float32, device=x.device)
    small = torch.empty(rows, cp, dtype=torch.float32, device=x.device)
    _build.function("pairwise_l2_tf32", "pairwise_l2_split_f32",
                    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 3, "pairwise_l2")(
        x.device, x.data_ptr(), rows, C, x.stride(0), x.stride(1), cp, norm.data_ptr(),
        big.data_ptr(), small.data_ptr())
    return norm, big, small


def _l2_matrix(x: torch.Tensor, y: torch.Tensor, squared: bool) -> torch.Tensor:
    """The pre-pass (once when x is y) and the 3xTF32 tensor-core kernel."""
    _check("pairwise_l2", x, y)
    (N, C), M = x.shape, y.shape[0]
    cp = max(-(-C // _K_TILE), 1) * _K_TILE
    xp = l2_split(x, cp)
    same = x.data_ptr() == y.data_ptr() and x.shape == y.shape and x.stride() == y.stride()
    yp = xp if same else l2_split(y, cp)
    out = torch.empty(N, M, dtype=torch.float32, device=x.device)
    _build.function("pairwise_l2_tf32", "pairwise_l2_tf32_f32",
                    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4, "pairwise_l2")(
        x.device, *(t.data_ptr() for t in (*xp, *yp, out)), N, M, cp, int(bool(squared)))
    return out


def pairwise_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x [N, C], y [M, C] f32 -> [N, M] L1 distances.

    CPU tensors take the plain version; CUDA tensors launch the L1 kernel of
    ``csrc/pairwise_distance.cu`` or raise. ``pairwise_l1.launches`` counts
    launches."""
    if x.device.type == "cpu":
        return pairwise_l1_plain(x, y)
    out = _launch("pairwise_l1", "pairwise_l1_f32", x, y)
    pairwise_l1.launches += 1
    return out


pairwise_l1.launches = 0


def pairwise_l2(x: torch.Tensor, y: torch.Tensor, squared: bool = False) -> torch.Tensor:
    """x [N, C], y [M, C] f32 -> [N, M] Euclidean (or squared) distances.

    CPU tensors take the plain version; CUDA tensors launch, for at most 8
    x rows, the row kernel of ``csrc/pairwise_distance.cu``, else the
    pre-pass and the 3xTF32 tensor-core kernel of
    ``csrc/pairwise_l2_tf32.cu`` (x.y computed in the kernels), or raise.
    ``pairwise_l2.launches`` counts calls that launched."""
    if x.device.type == "cpu":
        return pairwise_l2_plain(x, y, squared)
    if x.dim() == 2 and x.shape[0] > _ROW_MAX_N:
        out = _l2_matrix(x, y, squared)
    else:
        out = _launch("pairwise_l2", "pairwise_l2_f32", x, y, (int(bool(squared)),))
    pairwise_l2.launches += 1
    return out


pairwise_l2.launches = 0


def pairwise(x: torch.Tensor, y: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    if metric in ("l2", "euclidean"):
        return pairwise_l2(x, y)
    if metric == "l1":
        return pairwise_l1(x, y)
    raise ValueError(f"unknown metric {metric}")
