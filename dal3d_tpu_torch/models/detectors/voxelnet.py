"""FPNVoxelNet on host voxels (port of
``dal3d_tpu/models/detectors/voxelnet.py``): banded sparse backbone -> RPN ->
multi-group head, plus the pooled neck embedding the AL selectors read."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..backbones.scn import BANDED_CAPS_DEFAULT, BRICK_WIDTHS_DEFAULT, FPNSpMiddleResNetFHD
from ..heads.mg_head import MultiGroupHead
from ..necks.rpn import RPN


class FPNVoxelNet(nn.Module):
    def __init__(self, sparse_shape: Sequence[int],
                 num_classes: Sequence[int] = (1, 2, 2, 1, 2, 2),
                 code_size: int = 10, num_input_features: int = 5,
                 rpn_layer_nums=(5, 5), rpn_ds_strides=(1, 2),
                 rpn_ds_filters=(128, 256), rpn_us_strides=(1, 2),
                 rpn_us_filters=(256, 256), backbone_dtype: torch.dtype = torch.float32,
                 brick_widths=BRICK_WIDTHS_DEFAULT, banded_caps=BANDED_CAPS_DEFAULT):
        super().__init__()
        # depth left after the four downsamples (kernel 3, stride 2, z
        # padding 1, 1, 0, 0): the BEV map has 128 * d_out channels
        d_out = int(sparse_shape[0])
        for p in (1, 1, 0, 0):
            d_out = (d_out + 2 * p - 3) // 2 + 1
        self.backbone = FPNSpMiddleResNetFHD(sparse_shape, num_input_features,
                                             backbone_dtype, brick_widths, banded_caps)
        self.neck = RPN(rpn_layer_nums, rpn_ds_strides, rpn_ds_filters, rpn_us_strides,
                        rpn_us_filters, num_input_features=128 * d_out,
                        dtype=backbone_dtype)
        self.head = MultiGroupHead(num_classes, in_channels=sum(rpn_us_filters),
                                   code_size=code_size)

    def forward(self, vf: torch.Tensor, vc: torch.Tensor, vv: torch.Tensor):
        """Host voxels (features [B, N, F], coords [B, N, 3] zyx, valid
        [B, N]) -> {"preds", "embedding" [B, 512], "dense", "neck_feat",
        "middle"}."""
        dense, middle = self.backbone(vf, vc, vv)
        neck = self.neck(dense)
        return {
            "preds": self.head(neck),
            "embedding": neck.mean(dim=(1, 2)),
            "dense": dense,
            "neck_feat": neck,
            "middle": middle,
        }
