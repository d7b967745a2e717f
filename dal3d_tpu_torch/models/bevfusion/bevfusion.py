"""BEVFusion, lidar-only TransFusion-L (port of the lidar branch, decoder and
TransFusion head of ``dal3d_tpu/models/bevfusion/bevfusion.py``).

Host voxels, or raw points voxelized on the device (``voxelize_mean_grid``
at the config's grid) -> SparseEncoder (gather engine) -> dense BEV map ->
SECOND + SECONDFPN -> TransFusionHead. Train mode runs every batch norm on
batch statistics (moving the running ones as JAX's momenta do) and the
decoder's dropout; the loss is ``transfusion.py::transfusion_loss``. The
camera branch (Swin, LSS FPN, view transforms, fusers) is not ported and
raises with its ROADMAP item (A10.b); the CenterPoint head and map
segmentation raise in ``models/builder.py`` (A10.c).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...ops import sparse_backend as sp
from ...ops.voxelize import VoxelConfig, voxelize_mean_grid
from .second import SECOND, SECONDFPN
from .sparse_encoder import ENCODER_CHANNELS, VOXEL_CAPS, SparseEncoder
from .transfusion import TransFusionHead

STOP_AT = ("lidar", "decoder", "")


def _encoder_out_depth(D: int, n_downs: int) -> int:
    """Depth of the encoder's output: ``n_downs`` z-strided downsamples (z
    padding 1 for the first two, 0 after), then conv_out (3, 1, 1) /
    (2, 1, 1)."""
    for i in range(n_downs):
        D = (D + 2 * (1 if i < 2 else 0) - 3) // 2 + 1
    return (D - 3) // 2 + 1


class BEVFusion(nn.Module):
    def __init__(self, voxel_cfg: VoxelConfig, with_camera: bool = False,
                 num_classes: int = 10, num_proposals: int = 200,
                 decoder_channels: Sequence[int] = (128, 256),
                 decoder_layer_nums: Sequence[int] = (5, 5),
                 neck_out_channels: Sequence[int] = (256, 256),
                 voxel_caps: Sequence[int] = VOXEL_CAPS,
                 encoder_channels: Sequence[Sequence[int]] = ENCODER_CHANNELS,
                 hidden_channel: int = 128, num_heads: int = 8, ffn_channel: int = 256):
        super().__init__()
        if with_camera:
            raise NotImplementedError("BEVFusion's camera branch (Swin, LSS FPN, view "
                                      "transforms, fusers) is not ported: ROADMAP A10.b")
        self.voxel_cfg = voxel_cfg
        self.sparse_shape: Tuple[int, int, int] = voxel_cfg.sparse_shape
        self.encoder = SparseEncoder(encoder_channels=encoder_channels, voxel_caps=voxel_caps)
        bev_channels = int(encoder_channels[-1][-1]) * _encoder_out_depth(
            self.sparse_shape[0], len(encoder_channels) - 1)
        self.decoder = SECOND(bev_channels, decoder_channels, decoder_layer_nums)
        self.neck = SECONDFPN(decoder_channels, neck_out_channels)
        self.head = TransFusionHead(int(np.sum(neck_out_channels)), num_classes, num_proposals,
                                    hidden_channel, num_heads, ffn_channel)

    def forward(self, voxel_features: Optional[torch.Tensor] = None,
                voxel_coords: Optional[torch.Tensor] = None,
                voxel_valid: Optional[torch.Tensor] = None, stop_at: str = "", *,
                points: Optional[torch.Tensor] = None,
                points_valid: Optional[torch.Tensor] = None):
        """Host voxels (features [B, N, F], coords [B, N, 3] int (z, y, x),
        valid [B, N]), or with none of them raw ``points`` [B, P, F] and
        ``points_valid`` [B, P] voxelized here at the model's grid (as JAX's
        model without ``voxel_features``) -> the head's predictions with
        ``bev_feat`` (the neck's map [B, H, W, 512]). Fed voxels must lie in
        the grid. ``stop_at`` cuts the forward for the stage split: "lidar" ->
        {"lidar": encoder map}, "decoder" -> {"decoder": neck map}."""
        if stop_at not in STOP_AT:
            raise ValueError(f"stop_at={stop_at!r}: the lidar-only model stops at {STOP_AT}")
        if voxel_features is None:
            vox = voxelize_mean_grid(points, points_valid, self.voxel_cfg)
            voxel_features, voxel_coords = vox["features"], vox["coordinates"]
            valid = vox["voxel_valid"]
        else:
            valid = voxel_valid.bool()
            dims = torch.as_tensor(self.sparse_shape, device=voxel_coords.device)
            outside = ((voxel_coords < 0) | (voxel_coords >= dims)).any(-1) & valid
            if bool(outside.any()):
                raise ValueError(f"voxel coordinates outside the grid {self.sparse_shape}")
        sb = sp.from_voxels(voxel_features.float(), voxel_coords, valid, self.sparse_shape)
        lidar = self.encoder(sb)  # [B, H/8, W/8, 128 * 2]
        if stop_at == "lidar":
            return {"lidar": lidar}
        bev = self.neck(self.decoder(lidar))
        if stop_at == "decoder":
            return {"decoder": bev}
        preds = self.head(bev)
        preds["bev_feat"] = bev
        return preds
