"""GeneralizedLSSFPN camera neck (port of
``dal3d_tpu/models/bevfusion/lss_fpn.py``): a top-down pathway in which each
level concatenates its input with the coarser level's output, upsampled 2x
(``ops/resize.py``, JAX's bilinear) and cropped to the level's size, then
runs a 1x1 and a 3x3 conv, each bias-free + BN + ReLU. The coarsest input
passes on as it is. NHWC in and out; the convs run on the NCHW view.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...ops.resize import resize_bilinear
from ..layers import Conv2dBN


class GeneralizedLSSFPN(nn.Module):
    """``lateral_convs[i]`` / ``fpn_convs[i]`` serve level i (0 = finest);
    JAX creates them coarse to fine (``Conv_0`` is the last level's lateral
    conv)."""

    def __init__(self, in_channels: Sequence[int] = (192, 384, 768), out_channels: int = 256,
                 num_outs: int = 1):
        super().__init__()
        n = len(in_channels)
        self.num_outs = num_outs
        self.lateral_convs = nn.ModuleList()
        self.fpn_convs = nn.ModuleList()
        for i in range(n - 1):
            up = in_channels[-1] if i == n - 2 else out_channels
            self.lateral_convs.append(Conv2dBN(in_channels[i] + up, out_channels, 1))
            self.fpn_convs.append(Conv2dBN(out_channels, out_channels, 3, padding=1))

    def forward(self, inputs: Sequence[torch.Tensor]):
        n = len(inputs)
        outs = [None] * n
        outs[-1] = inputs[-1]
        for i in range(n - 2, -1, -1):
            H, W = inputs[i].shape[1:3]
            prev = outs[i + 1]
            up = resize_bilinear(prev, (2 * prev.shape[1], 2 * prev.shape[2]))[:, :H, :W]
            x = torch.cat([inputs[i], up], dim=-1).permute(0, 3, 1, 2)
            outs[i] = self.fpn_convs[i](self.lateral_convs[i](x)).permute(0, 2, 3, 1)
        return outs[:self.num_outs]
