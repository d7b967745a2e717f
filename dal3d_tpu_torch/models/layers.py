"""Building blocks of the sparse backbones and the dense necks (port of
``dal3d_tpu/models/layers.py``).

The sparse convs take a ``BrickBatch`` (the banded and brick engines of the
CBGS backbone), a ``SparseBatch`` (the gather engine, also BEVFusion's
encoder) or a ``(dense, occ)`` tuple (the dense compute of the ``hybrid``
and ``dense`` engines: [B, D, H, W, C] and its occupancy [B, D, H, W]).

Parameters stay f32, as in the JAX package, and are cast to the layer's
compute dtype at each call, so bf16 rounds in the same places. The norms
follow ``nn.Module.training``: batch statistics in train mode, running ones in
eval mode. Both keep the **biased** batch variance in the running average, as
the JAX modules do (``torch.nn.BatchNorm*d`` would store the unbiased one),
with momentum 0.01 in torch's convention.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import dense_sparse as ds
from ..ops import sparse_backend as sp
from ..ops import sparse_brick as spb
from ..parallel.dist import all_reduce_sum, get_dist_info

_STATS_FROZEN = [False]  # set while a checkpointed forward is recomputed


@contextlib.contextmanager
def _frozen_stats():
    """Running statistics stay as they are inside (a recomputed forward)."""
    prev = _STATS_FROZEN[0]
    _STATS_FROZEN[0] = True
    try:
        yield
    finally:
        _STATS_FROZEN[0] = prev


def remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint``: its activations are
    recomputed in backward instead of stored. The recomputation leaves the
    norms' running statistics alone, so they move once a step, as under
    JAX's functional remat. Without grad it is a plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), _frozen_stats()))


def _update_running(bn: nn.Module, mean: torch.Tensor, var: torch.Tensor) -> None:
    """running <- (1 - momentum) * running + momentum * batch, in place,
    outside the graph (not in a recomputed forward)."""
    if _STATS_FROZEN[0]:
        return
    with torch.no_grad():
        bn.running_mean.mul_(1 - bn.momentum).add_(mean, alpha=bn.momentum)
        bn.running_var.mul_(1 - bn.momentum).add_(var, alpha=bn.momentum)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over valid sparse voxels (eps 1e-3 and momentum 0.01 as the
    reference's BatchNorm1d).

    Train mode takes the masked mean and biased variance over every leading
    dim in f32 (count clamped to 1; padding voxels contribute nothing) and
    moves the running statistics towards them. The statistics fold into one
    multiply-add in the input dtype, as JAX's ``MaskedBatchNorm`` does, then
    padding voxels are zeroed."""

    def __init__(self, channels: int, eps: float = 1e-3, momentum: float = 0.01):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean, var = ds.masked_mean_var(x, mask)
            _update_running(self, mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        scale_eff = (self.weight * inv).to(x.dtype)
        bias_eff = (self.bias - mean * self.weight * inv).to(x.dtype)
        y = x * scale_eff + bias_eff
        return torch.where(mask[..., None], y, torch.zeros((), dtype=x.dtype, device=x.device))


class BatchNorm2d(nn.Module):
    """Dense NCHW batch norm with flax's arithmetic (eps 1e-3, momentum
    0.01): statistics and normalisation in f32, cast back to the input dtype.
    Train mode takes the batch mean and the fast biased variance
    max(0, E[x^2] - E[x]^2) over (B, H, W), as ``flax.linen.BatchNorm``."""

    def __init__(self, channels: int, eps: float = 1e-3, momentum: float = 0.01):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._norm(x, (0, 2, 3), (1, -1, 1, 1))

    def _norm(self, x: torch.Tensor, dims: tuple, shape: tuple) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean, var = self._batch_stats(xf, dims)
            _update_running(self, mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)

    def _batch_stats(self, xf: torch.Tensor, dims: tuple):
        """(E[x], max(0, E[x^2] - E[x]^2)) over ``dims``; in a world of
        several ranks over the global batch: the sums of x and x^2 and the
        count all-reduced in one differentiable collective."""
        if get_dist_info()[1] == 1:
            mean = xf.mean(dim=dims)
            return mean, torch.clamp(torch.square(xf).mean(dim=dims) - torch.square(mean),
                                     min=0.0)
        C = self.weight.shape[0]
        count = xf.new_full((1,), xf.numel() // C)
        sums = all_reduce_sum(torch.cat([xf.sum(dim=dims), torch.square(xf).sum(dim=dims),
                                         count]))
        mean = sums[:C] / sums[-1]
        return mean, torch.clamp(sums[C:2 * C] / sums[-1] - torch.square(mean), min=0.0)


class Conv2dBN(nn.Module):
    """NCHW conv (``nn.Conv2d``, with or without bias) + ``BatchNorm2d`` +
    ReLU: the conv / BN pairs of the camera branch and the fusers (flax
    ``nn.Conv`` + ``BatchNorm2d`` there, with the JAX module's bias)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 bias: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=bias)
        self.bn = BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class BatchNormLast(BatchNorm2d):
    """``BatchNorm2d``'s arithmetic over a channel-last input [..., C]
    (flax's ``BatchNorm`` normalises over every axis but the last), as
    TransFusion applies it to [B, N, C] query features with eps 1e-5 and
    momentum 0.1 (flax's 0.9)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._norm(x, tuple(range(x.ndim - 1)), (-1,))


class SubMConv(nn.Module):
    """Submanifold sparse conv with a prebuilt shared rulebook, on a
    BrickBatch (brick engines) or a SparseBatch (gather engine), or masked
    dense on a ``(dense, occ)`` tuple (no rulebook); weight [K, Cin, Cout] in
    z-major tap order. Inactive sites stay zero."""

    def __init__(self, cin: int, cout: int, kernel_size=3, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel_size = kernel_size
        self.dtype = dtype
        K = int(np.prod(spb._triple(kernel_size)))
        self.weight = nn.Parameter(torch.zeros(K, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def forward(self, x, rulebook=None):
        if isinstance(x, tuple):
            dense, occ = x
            occ = occ.to(self.dtype)
            out = ds.subm_conv_dense(dense.to(self.dtype), occ, self.weight, self.kernel_size)
            if self.bias is not None:
                out = (out + self.bias.to(self.dtype)) * occ[..., None]
            return out, occ
        if x.features.dtype != self.dtype:
            x = x.replace(features=x.features.to(self.dtype))
        if isinstance(x, sp.SparseBatch):
            out = sp.subm_conv(x, self.weight.to(self.dtype), rulebook, self.kernel_size)
            if self.bias is not None:
                out = out.replace(features=torch.where(
                    out.valid[..., None], out.features + self.bias.to(self.dtype),
                    torch.zeros((), dtype=self.dtype, device=out.lin.device)))
            return out
        out = spb.subm_conv(x, self.weight.to(self.dtype), rulebook, self.kernel_size)
        if self.bias is not None:
            bias_row = self.bias.to(self.dtype).repeat(out.bw)
            keep = out.vmask.repeat_interleave(self.weight.shape[-1], dim=-1)
            out = out.replace(features=torch.where(
                keep, out.features + bias_row, torch.zeros((), dtype=self.dtype,
                                                           device=keep.device)))
        return out


class SparseConvDown(nn.Module):
    """Strided sparse conv (new output active set of at most ``out_cap``
    sites) on a brick engine (``out_bw``: the output brick width;
    ``spatial``: the banded engine's y-major output order, else the brick
    engine's first-appearance order), the gather engine, or dense on a
    ``(dense, occ)`` tuple (no cap); bias-free as every downsample of the
    backbones."""

    def __init__(self, cin: int, cout: int, kernel_size, stride, padding,
                 out_cap: int, out_bw: int = 0, dtype: torch.dtype = torch.float32,
                 spatial: bool = True):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.out_cap, self.out_bw, self.dtype = out_cap, out_bw, dtype
        self.spatial = spatial
        K = int(np.prod(spb._triple(kernel_size)))
        self.weight = nn.Parameter(torch.zeros(K, cin, cout))

    def forward(self, x, grid: torch.Tensor | None = None):
        if isinstance(x, tuple):
            dense, occ = x
            return ds.sparse_conv_down_dense(dense.to(self.dtype), occ.to(self.dtype),
                                             self.weight, self.kernel_size, self.stride,
                                             self.padding)
        if x.features.dtype != self.dtype:
            x = x.replace(features=x.features.to(self.dtype))
        if isinstance(x, sp.SparseBatch):
            return sp.sparse_conv_downsample(x, self.weight.to(self.dtype), self.kernel_size,
                                             self.stride, self.padding, self.out_cap, grid)
        return spb.downsample_conv_banded(
            x, self.weight.to(self.dtype), self.kernel_size, self.stride, self.padding,
            out_bw=self.out_bw, out_cap=self.out_cap, grid=grid, spatial=self.spatial)
