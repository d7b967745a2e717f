"""Dense SECOND BEV decoder and SECONDFPN neck (port of the lidar-only part
of ``dal3d_tpu/models/bevfusion/second.py``; ``ConvFuser`` and ``AddFuser``
wait for the camera branch, ROADMAP A10).

NHWC in and out, as the JAX modules; inside, the convs run on the NCHW view
of the same memory through cuDNN (which JAX also leaves to its compiler: no
Pallas kernel computes them). Every conv is bias-free + BN (eps 1e-3) +
ReLU.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

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
