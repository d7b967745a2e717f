"""Dense image backbones (port of ``dal3d_tpu/models/backbones/image.py``;
the reference's det3d/models/backbones/{resnet,senet,ssd_vgg}.py): a
ResNet-18/34-style network returning its four stage maps, the same with
squeeze-excitation blocks (SENet), and a VGG-16 feature extractor with
SSD's dilated fc6 / fc7 returning (conv4_3, fc7). NCHW; no config uses
them, so they are built directly.

JAX's choices are kept: ``k // 2`` padding, bias-free convs in the residual
blocks, flax's batch norm (``layers.BatchNorm2d``: eps 1e-3, momentum 0.01,
biased running variance), a 3x3 / 2 max pool with -inf padding after
ResNet's stem, VALID 2x2 pools between VGG's stages and fc6 at padding and
dilation 6. Train mode is the module's ``training`` flag (batch statistics,
which also move the running ones). On the card a caller runs the forward
under ``runtime/steps.py::autotuned_convs`` (TF32 off, cuDNN's autotuner, so
no FFT route for the f32 convs), as the steps run every other model's.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import BatchNorm2d


def _conv(cin: int, cout: int, k: int = 3, s: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=s, padding=k // 2, bias=bias)


class BasicBlock(nn.Module):
    """conv-BN-ReLU, conv-BN, optional squeeze-excitation (``se_ratio`` >
    0), a 1x1 conv-BN projection when the shape changes, ReLU of the sum."""

    def __init__(self, cin: int, ch: int, stride: int = 1, se_ratio: int = 0):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, ch, s=stride), BatchNorm2d(ch)
        self.conv2, self.bn2 = _conv(ch, ch), BatchNorm2d(ch)
        self.se = None
        if se_ratio:
            self.se = nn.Sequential(nn.Linear(ch, ch // se_ratio), nn.ReLU(),
                                    nn.Linear(ch // se_ratio, ch), nn.Sigmoid())
        self.proj = None
        if stride != 1 or cin != ch:
            self.proj = nn.Sequential(_conv(cin, ch, k=1, s=stride), BatchNorm2d(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.se is not None:
            out = out * self.se(out.mean(dim=(2, 3)))[:, :, None, None]
        identity = x if self.proj is None else self.proj(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """ResNet-18/34-style backbone: 7x7 / 2 stem, 3x3 / 2 max pool, then
    ``stage_blocks`` basic blocks per stage (the first of stages 2-4 at
    stride 2). x [B, in_channels, H, W] -> the four stage maps."""

    def __init__(self, stage_blocks: Sequence[int] = (2, 2, 2, 2),
                 channels: Sequence[int] = (64, 128, 256, 512), se_ratio: int = 0,
                 in_channels: int = 3):
        super().__init__()
        self.stem = _conv(in_channels, 64, k=7, s=2)
        self.stem_bn = BatchNorm2d(64)
        stages, cin = [], 64
        for i, (n, ch) in enumerate(zip(stage_blocks, channels)):
            blocks = []
            for j in range(n):
                blocks.append(BasicBlock(cin, ch, stride=2 if (i > 0 and j == 0) else 1,
                                         se_ratio=se_ratio))
                cin = ch
            stages.append(nn.Sequential(*blocks))
        self.stages = nn.ModuleList(stages)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = F.relu(self.stem_bn(self.stem(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        outs = []
        for stage in self.stages:
            x = stage(x)
            outs.append(x)
        return tuple(outs)


class SENet(ResNet):
    """ResNet with squeeze-excitation blocks (reference senet.py), ratio 16."""

    def __init__(self, stage_blocks: Sequence[int] = (2, 2, 2, 2),
                 channels: Sequence[int] = (64, 128, 256, 512), se_ratio: int = 16,
                 in_channels: int = 3):
        super().__init__(stage_blocks, channels, se_ratio, in_channels)


class SSDVGG(nn.Module):
    """VGG-16-style extractor with SSD's extra convs (reference ssd_vgg.py):
    stages of 3x3 convs with bias and ReLU, 2x2 / 2 pools between them;
    returns (conv4_3, the fourth stage's last map; fc7, 1024 channels, after
    the dilated 3x3 fc6 and the 1x1 fc7 on the fifth stage)."""

    def __init__(self, depths: Sequence[int] = (2, 2, 3, 3, 3),
                 channels: Sequence[int] = (64, 128, 256, 512, 512), in_channels: int = 3):
        super().__init__()
        stages, cin = [], in_channels
        for n, ch in zip(depths, channels):
            convs = []
            for _ in range(n):
                convs.append(_conv(cin, ch, bias=True))
                cin = ch
            stages.append(nn.ModuleList(convs))
        self.stages = nn.ModuleList(stages)
        self.fc6 = nn.Conv2d(cin, 1024, 3, padding=6, dilation=6)
        self.fc7 = nn.Conv2d(1024, 1024, 1)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        outs = []
        for i, stage in enumerate(self.stages):
            for conv in stage:
                x = F.relu(conv(x))
            if i == 3:
                outs.append(x)  # conv4_3
            if i < len(self.stages) - 1:
                x = F.max_pool2d(x, 2, stride=2)
        x = F.relu(self.fc7(F.relu(self.fc6(x))))
        outs.append(x)
        return tuple(outs)
