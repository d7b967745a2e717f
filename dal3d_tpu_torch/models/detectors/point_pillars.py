"""PointPillars detector (port of ``dal3d_tpu/models/detectors/
point_pillars.py``; the reference's det3d/models/detectors/point_pillars.py:6):
raw points -> ``pillarize`` -> ``PillarFeatureNet`` -> ``PointPillarsScatter``
BEV canvas -> RPN -> ``MultiGroupHead``, with the fields and defaults of the
JAX module. No config builds it, in JAX or here: it is built directly."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ...ops.voxelize import VoxelConfig
from ..heads.mg_head import MultiGroupHead
from ..necks.rpn import RPN
from ..readers.pillar_encoder import PillarFeatureNet, PointPillarsScatter, pillarize


class PointPillars(nn.Module):
    def __init__(self, voxel_cfg: VoxelConfig, num_classes: Sequence[int] = (1,),
                 code_size: int = 10, num_input_features: int = 4,
                 pfn_filters: Tuple[int, ...] = (64,),
                 rpn_layer_nums: Tuple[int, ...] = (3, 5, 5),
                 rpn_ds_strides: Tuple[int, ...] = (2, 2, 2),
                 rpn_ds_filters: Tuple[int, ...] = (64, 128, 256),
                 rpn_us_strides: Tuple[int, ...] = (1, 2, 4),
                 rpn_us_filters: Tuple[int, ...] = (128, 128, 128)):
        super().__init__()
        self.voxel_cfg = voxel_cfg
        self.pfn = PillarFeatureNet(num_input_features, pfn_filters,
                                    voxel_size=voxel_cfg.voxel_size[:2],
                                    pc_range=voxel_cfg.point_cloud_range[:2])
        self.scatter = PointPillarsScatter(pfn_filters[-1])
        self.neck = RPN(rpn_layer_nums, rpn_ds_strides, rpn_ds_filters, rpn_us_strides,
                        rpn_us_filters, num_input_features=pfn_filters[-1])
        self.head = MultiGroupHead(num_classes, in_channels=sum(rpn_us_filters),
                                   code_size=code_size)

    def forward(self, points: torch.Tensor, points_valid: torch.Tensor):
        """points [B, P, F], points_valid [B, P] -> {"preds", "embedding"
        [B, C], "neck_feat" [B, H', W', C]}."""
        nx, ny, _ = self.voxel_cfg.grid_size
        ok, pid, coords, pvalid = pillarize(points, points_valid, self.voxel_cfg)
        pf = self.pfn(points, ok, pid, coords, pvalid)
        neck = self.neck(self.scatter(pf, coords, pvalid, nx, ny))
        return {"preds": self.head(neck), "embedding": neck.mean(dim=(1, 2)),
                "neck_feat": neck}
