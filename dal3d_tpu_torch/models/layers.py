"""Building blocks of the sparse backbone and the dense neck (port of the
brick branches of ``dal3d_tpu/models/layers.py``), in eval mode.

Parameters stay f32, as in the JAX package, and are cast to the layer's
compute dtype at each call, so bf16 rounds in the same places.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops import sparse_brick as spb


class MaskedBatchNorm(nn.Module):
    """BatchNorm over valid sparse voxels, eval mode (running statistics;
    eps 1e-3 as the reference's BatchNorm1d).

    The statistics fold into one multiply-add in the input dtype, as JAX's
    ``MaskedBatchNorm`` does, then padding voxels are zeroed."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps)
        scale_eff = (self.weight * inv).to(x.dtype)
        bias_eff = (self.bias - self.running_mean * self.weight * inv).to(x.dtype)
        y = x * scale_eff + bias_eff
        return torch.where(mask[..., None], y, torch.zeros((), dtype=x.dtype, device=x.device))


class BatchNorm2d(nn.Module):
    """Dense NCHW batch norm, eval mode, with flax's arithmetic: normalise in
    f32, cast back to the input dtype (eps 1e-3)."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class SubMConv(nn.Module):
    """Submanifold sparse conv on a BrickBatch with a prebuilt shared
    rulebook; weight [K, Cin, Cout] in z-major tap order."""

    def __init__(self, cin: int, cout: int, kernel_size=3, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel_size = kernel_size
        self.dtype = dtype
        K = int(np.prod(spb._triple(kernel_size)))
        self.weight = nn.Parameter(torch.zeros(K, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def forward(self, x: spb.BrickBatch, rulebook: spb.BandedSubmRulebook) -> spb.BrickBatch:
        if x.features.dtype != self.dtype:
            x = x.replace(features=x.features.to(self.dtype))
        out = spb.subm_conv(x, self.weight.to(self.dtype), rulebook, self.kernel_size)
        if self.bias is not None:
            bias_row = self.bias.to(self.dtype).repeat(out.bw)
            keep = out.vmask.repeat_interleave(self.weight.shape[-1], dim=-1)
            out = out.replace(features=torch.where(
                keep, out.features + bias_row, torch.zeros((), dtype=self.dtype,
                                                           device=keep.device)))
        return out


class SparseConvDown(nn.Module):
    """Strided sparse conv (new output active set) on the banded engine,
    bias-free as every downsample of the backbone."""

    def __init__(self, cin: int, cout: int, kernel_size, stride, padding,
                 out_cap: int, out_bw: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.out_cap, self.out_bw, self.dtype = out_cap, out_bw, dtype
        K = int(np.prod(spb._triple(kernel_size)))
        self.weight = nn.Parameter(torch.zeros(K, cin, cout))

    def forward(self, x: spb.BrickBatch, grid: torch.Tensor | None = None) -> spb.BrickBatch:
        if x.features.dtype != self.dtype:
            x = x.replace(features=x.features.to(self.dtype))
        return spb.downsample_conv_banded(
            x, self.weight.to(self.dtype), self.kernel_size, self.stride, self.padding,
            out_bw=self.out_bw, out_cap=self.out_cap, grid=grid)
