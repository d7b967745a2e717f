"""FPNVoxelNet (port of ``dal3d_tpu/models/detectors/voxelnet.py``): host
voxels, or raw points voxelized on the input's device -> sparse backbone
(``backbone_impl``: "banded", "brick", "gather" (JAX's default), "hybrid" or
"dense"; the backbone routes the voxels as JAX's detector does: a brick pack
for the brick engines, a SparseBatch for the others) -> RPN -> multi-group
head, plus the pooled neck embedding the AL selectors read."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...ops.voxelize import VoxelConfig, voxelize_mean, voxelize_mean_grid
from ..backbones.scn import (BANDED_CAPS_DEFAULT, BRICK_CAPS_DEFAULT, BRICK_WIDTHS_DEFAULT,
                             VOXEL_CAPS_DEFAULT, FPNSpMiddleResNetFHD)
from ..heads.mg_head import MultiGroupHead
from ..necks.rpn import RPN


class FPNVoxelNet(nn.Module):
    def __init__(self, sparse_shape: Sequence[int],
                 num_classes: Sequence[int] = (1, 2, 2, 1, 2, 2),
                 code_size: int = 10, num_input_features: int = 5,
                 rpn_layer_nums=(5, 5), rpn_ds_strides=(1, 2),
                 rpn_ds_filters=(128, 256), rpn_us_strides=(1, 2),
                 rpn_us_filters=(256, 256), backbone_dtype: torch.dtype = torch.float32,
                 brick_widths=BRICK_WIDTHS_DEFAULT, banded_caps=BANDED_CAPS_DEFAULT,
                 voxel_cfg: Optional[VoxelConfig] = None, sort_free_voxelize: bool = True,
                 backbone_impl: str = "banded", voxel_caps=VOXEL_CAPS_DEFAULT,
                 brick_caps=BRICK_CAPS_DEFAULT):
        super().__init__()
        # the device voxelizer of a raw-point forward: the grid variant
        # (ascending cells, mean of all points) unless sort_free_voxelize is
        # off (first arrivals, mean of the first max_points_in_voxel)
        self.voxel_cfg = voxel_cfg
        self.sort_free_voxelize = sort_free_voxelize
        # depth left after the four downsamples (kernel 3, stride 2, z
        # padding 1, 1, 0, 0): the BEV map has 128 * d_out channels
        d_out = int(sparse_shape[0])
        for p in (1, 1, 0, 0):
            d_out = (d_out + 2 * p - 3) // 2 + 1
        self.backbone = FPNSpMiddleResNetFHD(sparse_shape, num_input_features,
                                             backbone_dtype, brick_widths, banded_caps,
                                             backbone_impl, voxel_caps, brick_caps)
        self.neck = RPN(rpn_layer_nums, rpn_ds_strides, rpn_ds_filters, rpn_us_strides,
                        rpn_us_filters, num_input_features=128 * d_out,
                        dtype=backbone_dtype)
        self.head = MultiGroupHead(num_classes, in_channels=sum(rpn_us_filters),
                                   code_size=code_size)

    def voxelize(self, points: torch.Tensor, points_valid: torch.Tensor):
        """Raw points [B, P, F] + validity [B, P] -> (features [B, M, F],
        coords [B, M, 3] zyx, valid [B, M]) on the points' device."""
        if self.voxel_cfg is None:
            raise ValueError("a raw-point forward needs the model's voxel_cfg")
        fn = voxelize_mean_grid if self.sort_free_voxelize else voxelize_mean
        vox = fn(points, points_valid, self.voxel_cfg)
        return vox["features"], vox["coordinates"], vox["voxel_valid"]

    def forward(self, vf: Optional[torch.Tensor] = None, vc: Optional[torch.Tensor] = None,
                vv: Optional[torch.Tensor] = None, *, points: Optional[torch.Tensor] = None,
                points_valid: Optional[torch.Tensor] = None):
        """Host voxels (features [B, N, F], coords [B, N, 3] zyx, valid
        [B, N]), or with none of them raw ``points`` [B, P, F] and
        ``points_valid`` [B, P], voxelized here (as JAX's ``__call__`` with
        ``voxels=None``) -> {"preds", "embedding" [B, 512], "dense",
        "neck_feat", "middle"}."""
        if vf is None:
            vf, vc, vv = self.voxelize(points, points_valid)
        dense, middle = self.backbone(vf, vc, vv)
        neck = self.neck(dense)
        return {
            "preds": self.head(neck),
            "embedding": neck.mean(dim=(1, 2)),
            "dense": dense,
            "neck_feat": neck,
            "middle": middle,
        }
