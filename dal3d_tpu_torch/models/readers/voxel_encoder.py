"""The mean voxel feature extractor (port of
``dal3d_tpu/models/readers/voxel_encoder.py``; the reference's
det3d/models/readers/voxel_encoder.py:198-210).

On the port's main path the mean is fused into the voxelizers (the host's
``core/voxel_generator.py``, the device's ``ops/voxelize.py``), so the
model reads voxel features as they are; this module is the standalone
reader of the [M, K, F] voxels path.
"""
from __future__ import annotations

import torch
from torch import nn


class VoxelFeatureExtractorV3(nn.Module):
    """voxels [..., K, F], num_points [...] -> [..., F]: the mean of each
    voxel's first ``num_points`` points, divided by max(num_points, 1)."""

    def __init__(self, num_input_features: int = 5):
        super().__init__()
        self.num_input_features = num_input_features

    def forward(self, voxels: torch.Tensor, num_points: torch.Tensor) -> torch.Tensor:
        K = voxels.shape[-2]
        mask = torch.arange(K, device=voxels.device) < num_points[..., None]
        s = (voxels * mask[..., None].to(voxels.dtype)).sum(dim=-2)
        return s / torch.clamp(num_points, min=1)[..., None].to(voxels.dtype)
