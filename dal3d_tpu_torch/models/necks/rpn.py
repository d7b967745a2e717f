"""Dense BEV RPN neck (port of ``dal3d_tpu/models/necks/rpn.py``).

NHWC in and out, as the JAX module; inside, the convs run on the NCHW view
of the same memory (channels-last) through ``torch.nn.functional`` convs,
which JAX also leaves to its compiler (no Pallas kernel computes them). All
convs are bias-free + BN (eps 1e-3) + ReLU; each block is a stride conv then
``layer_num`` 3x3 convs, and each upsample branch a transpose conv (stride
> 1) or a strided conv.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..layers import BatchNorm2d


class ConvBN(nn.Module):
    """conv (or transpose conv) + BN + ReLU in the compute dtype."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, padding: int,
                 transpose: bool, dtype: torch.dtype):
        super().__init__()
        self.stride, self.padding, self.transpose, self.dtype = stride, padding, transpose, dtype
        shape = (cin, cout, k, k) if transpose else (cout, cin, k, k)
        self.weight = nn.Parameter(torch.zeros(shape))
        self.bn = BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.dtype)
        conv = F.conv_transpose2d if self.transpose else F.conv2d
        return torch.relu(self.bn(conv(x, w, stride=self.stride, padding=self.padding)))


class RPN(nn.Module):
    def __init__(self, layer_nums: Sequence[int] = (5, 5),
                 ds_layer_strides: Sequence[int] = (1, 2),
                 ds_num_filters: Sequence[int] = (128, 256),
                 us_layer_strides: Sequence[int] = (1, 2),
                 us_num_filters: Sequence[int] = (256, 256),
                 num_input_features: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.upsample_start = len(layer_nums) - len(us_layer_strides)
        self.blocks = nn.ModuleList()
        self.deblocks = nn.ModuleList()
        cin = num_input_features
        for i, layer_num in enumerate(layer_nums):
            planes = ds_num_filters[i]
            convs = [ConvBN(cin, planes, 3, ds_layer_strides[i], 1, False, dtype)]
            convs += [ConvBN(planes, planes, 3, 1, 1, False, dtype) for _ in range(layer_num)]
            self.blocks.append(nn.Sequential(*convs))
            cin = planes
            d = i - self.upsample_start
            if d >= 0:
                us, filters = us_layer_strides[d], us_num_filters[d]
                if us > 1:
                    self.deblocks.append(ConvBN(planes, filters, us, us, 0, True, dtype))
                else:
                    k = int(np.round(1 / us))
                    self.deblocks.append(ConvBN(planes, filters, k, k, 0, False, dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, H, W, C] -> [B, H', W', sum(us_num_filters)] f32."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NCHW view, channels-last memory
        ups = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            d = i - self.upsample_start
            if d >= 0:
                ups.append(self.deblocks[d](x))
        if ups:
            x = torch.cat(ups, dim=1)
        return x.permute(0, 2, 3, 1).float()
