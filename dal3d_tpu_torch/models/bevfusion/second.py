"""Dense SECOND BEV decoder, SECONDFPN neck and the camera + lidar fusers
``ConvFuser`` and ``AddFuser`` (port of
``dal3d_tpu/models/bevfusion/second.py``).

NHWC in and out, as the JAX modules; inside, the convs run on the NCHW view
of the same memory through cuDNN (which JAX also leaves to its compiler: no
Pallas kernel computes them). Every conv is bias-free + BN (eps 1e-3) +
ReLU.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..layers import Conv2dBN
from ..necks.rpn import ConvBN


class SECOND(nn.Module):
    """Per block: a 3x3 conv at the block's stride, then ``layer_nums[i]``
    3x3 convs; returns every block's output (NCHW)."""

    def __init__(self, in_channels: int, out_channels: Sequence[int] = (128, 256),
                 layer_nums: Sequence[int] = (5, 5), layer_strides: Sequence[int] = (1, 2)):
        super().__init__()
        self.blocks = nn.ModuleList()
        cin = in_channels
        for cout, n, s in zip(out_channels, layer_nums, layer_strides):
            convs = [ConvBN(cin, cout, 3, s, 1, False, torch.float32)]
            convs += [ConvBN(cout, cout, 3, 1, 1, False, torch.float32) for _ in range(n)]
            self.blocks.append(nn.Sequential(*convs))
            cin = cout

    def forward(self, x: torch.Tensor):
        """x [B, H, W, C] -> list of NCHW maps."""
        x = x.permute(0, 3, 1, 2)  # NCHW view, channels-last memory
        outs = []
        for block in self.blocks:
            x = block(x)
            outs.append(x)
        return outs


class SECONDFPN(nn.Module):
    """Per input: a transposed conv (stride > 1) or a 1x1 conv to
    ``out_channels[i]``, then BN + ReLU; the branches concatenated, NHWC."""

    def __init__(self, in_channels: Sequence[int], out_channels: Sequence[int] = (256, 256),
                 upsample_strides: Sequence[int] = (1, 2)):
        super().__init__()
        self.deblocks = nn.ModuleList(
            ConvBN(cin, cout, s, s, 0, s > 1, torch.float32)
            for cin, cout, s in zip(in_channels, out_channels, upsample_strides))

    def forward(self, xs) -> torch.Tensor:
        ups = [deblock(x) for deblock, x in zip(self.deblocks, xs)]
        return torch.cat(ups, dim=1).permute(0, 2, 3, 1)


class ConvFuser(nn.Module):
    """concat(camera, lidar) on channels -> bias-free 3x3 conv -> BN -> ReLU;
    NHWC maps in and out."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256):
        super().__init__()
        self.fuse = Conv2dBN(int(sum(in_channels)), out_channels, 3, padding=1)

    def forward(self, feats) -> torch.Tensor:
        x = torch.cat(list(feats), dim=-1).permute(0, 3, 1, 2)
        return self.fuse(x).permute(0, 2, 3, 1)


class AddFuser(nn.Module):
    """Per modality a bias-free 3x3 conv + BN + ReLU, then the mean over the
    modalities. In train mode with ``dropout`` > 0, one modality drawn at
    random is zeroed with that probability and the mean is taken over the
    others; the draws come from ``self.generator`` (set by the train step;
    None draws from the device's default generator). NHWC in and out."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 dropout: float = 0.0):
        super().__init__()
        self.convs = nn.ModuleList(Conv2dBN(c, out_channels, 3, padding=1) for c in in_channels)
        self.dropout = float(dropout)
        self.generator = None

    def forward(self, feats) -> torch.Tensor:
        outs = torch.stack([conv(f.permute(0, 3, 1, 2)) for conv, f in zip(self.convs, feats)])
        n = outs.shape[0]
        weights = torch.ones(n, device=outs.device)
        if self.training and self.dropout > 0 and n > 1:
            drop = torch.rand((), generator=self.generator, device=outs.device) < self.dropout
            victim = torch.randint(n, (), generator=self.generator, device=outs.device)
            hit = drop & (torch.arange(n, device=outs.device) == victim)
            weights = torch.where(hit, torch.zeros_like(weights), weights)
        out = (outs * weights.view(n, 1, 1, 1, 1)).sum(0) / weights.sum()
        return out.permute(0, 2, 3, 1)
