"""BEVFusion lidar branch: SparseEncoder on the gather engine (port of
``dal3d_tpu/models/bevfusion/sparse_encoder.py``).

conv_input SubM stem, four encoder stages over channels ((16, 16, 32),
(32, 32, 64), (64, 64, 128), (128, 128)): stages 0-2 are two bias-free
residual SparseBasicBlocks and a strided downsample (stage 2 with z-padding
0), stage 3 is two blocks; then the conv_out z-squash (kernel (3, 1, 1),
stride (2, 1, 1)) and a dense NHWC map [B, H/8, W/8, 128 * D] with channel
c*D + d.

The JAX module builds each level's index grid twice (once for the subm
rulebook, once more inside the downsample). This one builds it once per
level and shares it: the same plans, one grid (340 MB per frame at L0) less.
Each level's subm rulebook carries the gather-GEMM kernel's walk plan, made
once and shared by the level's subm convs (at L0 the stem's too).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ...ops import sparse_backend as sp
from ..backbones.scn import SparseBasicBlock
from ..layers import MaskedBatchNorm, SparseConvDown, SubMConv

ENCODER_CHANNELS = ((16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128))
VOXEL_CAPS = (120000, 60000, 30000, 30000)


def _bn_relu(bn: MaskedBatchNorm, x: sp.SparseBatch) -> sp.SparseBatch:
    return x.replace(features=torch.relu(bn(x.features, x.valid)))


class _Stage(nn.Module):
    def __init__(self, chans: Tuple[int, ...], down: bool, pad, cap: int):
        super().__init__()
        blocks = chans[:-1] if down else chans
        self.blocks = nn.ModuleList(SparseBasicBlock(c, torch.float32, use_bias=False)
                                    for c in blocks)
        self.down = (SparseConvDown(blocks[-1], chans[-1], (3, 3, 3), (2, 2, 2), pad, cap)
                     if down else None)
        self.down_bn = MaskedBatchNorm(chans[-1]) if down else None


class SparseEncoder(nn.Module):
    def __init__(self, in_channels: int = 5,
                 encoder_channels: Sequence[Sequence[int]] = ENCODER_CHANNELS,
                 voxel_caps: Sequence[int] = VOXEL_CAPS):
        super().__init__()
        ec = tuple(tuple(int(c) for c in chans) for chans in encoder_channels)
        self.stem = SubMConv(in_channels, ec[0][0], use_bias=False)
        self.stem_bn = MaskedBatchNorm(ec[0][0])
        n = len(ec)
        self.stages = nn.ModuleList(
            _Stage(chans, i < n - 1, (1, 1, 1) if i < 2 else (0, 1, 1), int(voxel_caps[i]))
            for i, chans in enumerate(ec))
        c = ec[-1][-1]
        self.conv_out = SparseConvDown(c, c, (3, 1, 1), (2, 1, 1), (0, 0, 0),
                                       int(voxel_caps[-1]))
        self.conv_out_bn = MaskedBatchNorm(c)

    def forward(self, sb: sp.SparseBatch) -> torch.Tensor:
        """SparseBatch at the voxel grid -> dense BEV map [B, H', W', C*D']."""
        grid = sp.build_index_grid(sb)
        rb = sp.with_plan(sp.subm_rulebook(sb, 3, grid))
        x = _bn_relu(self.stem_bn, self.stem(sb, rb))
        for i, stage in enumerate(self.stages):
            if i > 0:
                grid = sp.build_index_grid(x)
                rb = sp.with_plan(sp.subm_rulebook(x, 3, grid))
            for block in stage.blocks:
                x = block(x, rb)
            if stage.down is not None:
                x = _bn_relu(stage.down_bn, stage.down(x, grid))
        x = _bn_relu(self.conv_out_bn, self.conv_out(x, grid))
        return sp.to_dense(x)
