"""BEVFusion: lidar-only TransFusion-L (stage 1) and camera + lidar fusion
(stage 2) (port of ``dal3d_tpu/models/bevfusion/bevfusion.py``).

Lidar branch: host voxels, or raw points voxelized on the device
(``voxelize_mean_grid`` at the config's grid) -> SparseEncoder (gather
engine) -> dense BEV map. Camera branch (``with_camera``): the B x N images
-> Swin-T -> GeneralizedLSSFPN -> ``DepthLSSTransform`` (lidar depth images
in) or ``LSSTransform`` (``vtransform``) -> camera BEV map, resized to the
lidar grid when the sizes differ (``ops/resize.py``). Both branches meet in
``ConvFuser``; ``with_lidar=False`` runs the camera alone. Then SECOND +
SECONDFPN -> the detection head: ``TransFusionHead`` (``head="transfusion"``)
or the per-task ``CenterHead`` (``head="centerpoint"``, its predictions under
``center_preds``); with ``with_map_seg`` the ``BEVSegmentationHead`` adds
``seg_logits`` [B, H, W, C] from the same neck map. Train mode runs every
batch norm on batch statistics (moving the running ones as JAX's momenta
do), the decoder's dropout and Swin's stochastic depth; the TransFusion loss
is ``transfusion.py::transfusion_loss``, the centre head's
``centerpoint.py::center_head_loss``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...ops import sparse_backend as sp
from ...ops.resize import resize_bilinear
from ...ops.voxelize import VoxelConfig, voxelize_mean_grid
from .centerpoint import CenterHead
from .lss_fpn import GeneralizedLSSFPN
from .second import SECOND, SECONDFPN, ConvFuser
from .segm import SEG_CLASSES, BEVSegmentationHead
from .sparse_encoder import ENCODER_CHANNELS, VOXEL_CAPS, SparseEncoder
from .swin import SwinTransformer
from .transfusion import TransFusionHead
from .vtransforms import DepthLSSTransform, LSSTransform

STOP_AT = ("lidar", "camera", "fused", "decoder", "")
VTRANSFORMS = ("depth_lss", "lss")
HEADS = ("transfusion", "centerpoint")
CAMERA_TRANSFORMS = ("camera2lidar_rots", "camera2lidar_trans", "camera_intrinsics",
                     "img_aug_rots", "img_aug_trans")


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
                 hidden_channel: int = 128, num_heads: int = 8, ffn_channel: int = 256,
                 with_lidar: bool = True, vtransform: str = "depth_lss",
                 image_size: Tuple[int, int] = (256, 704), camera_out_channels: int = 80,
                 head: str = "transfusion",
                 center_task_classes: Sequence[int] = (1, 2, 2, 1, 2, 2),
                 with_map_seg: bool = False, seg_classes: Sequence[str] = SEG_CLASSES):
        super().__init__()
        if head not in HEADS:
            raise ValueError(f"unknown head {head!r} (expected one of {HEADS})")
        if not (with_lidar or with_camera):
            raise ValueError("BEVFusion needs at least one branch (with_lidar and/or "
                             "with_camera)")
        if vtransform not in VTRANSFORMS:
            raise ValueError(f"unknown vtransform {vtransform!r} (expected one of "
                             f"{VTRANSFORMS})")
        self.voxel_cfg = voxel_cfg
        self.sparse_shape: Tuple[int, int, int] = voxel_cfg.sparse_shape
        self.with_lidar, self.with_camera, self.vtransform = with_lidar, with_camera, vtransform
        branches = []
        if with_lidar:
            self.encoder = SparseEncoder(encoder_channels=encoder_channels, voxel_caps=voxel_caps)
            branches.append(int(encoder_channels[-1][-1]) * _encoder_out_depth(
                self.sparse_shape[0], len(encoder_channels) - 1))
        if with_camera:
            self.camera_backbone = SwinTransformer()
            self.camera_neck = GeneralizedLSSFPN(self.camera_backbone.out_channels, 256, 1)
            lss = DepthLSSTransform if vtransform == "depth_lss" else LSSTransform
            self.camera_vtransform = lss(256, camera_out_channels, image_size)
            branches.insert(0, camera_out_channels)
        self.fuser = ConvFuser(branches, 256) if len(branches) > 1 else None
        bev_channels = 256 if self.fuser is not None else branches[0]
        self.decoder = SECOND(bev_channels, decoder_channels, decoder_layer_nums)
        self.neck = SECONDFPN(decoder_channels, neck_out_channels)
        neck_channels = int(np.sum(neck_out_channels))
        self.head_type = head
        if head == "centerpoint":
            self.head = CenterHead(neck_channels, center_task_classes)
        else:
            self.head = TransFusionHead(neck_channels, num_classes, num_proposals,
                                        hidden_channel, num_heads, ffn_channel)
        self.seg_head = BEVSegmentationHead(neck_channels, seg_classes) if with_map_seg else None

    def forward(self, voxel_features: Optional[torch.Tensor] = None,
                voxel_coords: Optional[torch.Tensor] = None,
                voxel_valid: Optional[torch.Tensor] = None, stop_at: str = "", *,
                points: Optional[torch.Tensor] = None,
                points_valid: Optional[torch.Tensor] = None,
                images: Optional[torch.Tensor] = None,
                depth_images: Optional[torch.Tensor] = None, **camera):
        """Host voxels (features [B, N, F], coords [B, N, 3] int (z, y, x),
        valid [B, N]), or with none of them raw ``points`` [B, P, F] and
        ``points_valid`` [B, P] voxelized here at the model's grid (as JAX's
        model without ``voxel_features``); with the camera branch also
        ``images`` [B, Nc, iH, iW, 3], ``depth_images`` [B, Nc, iH, iW, 1]
        (``depth_lss``) and the ``CAMERA_TRANSFORMS`` (camera2lidar
        rots / trans, intrinsics, image-augmentation rots / trans) -> the
        head's predictions with ``bev_feat`` (the neck's map [B, H, W, 512]).
        Fed voxels must lie in the grid. ``stop_at`` cuts the forward for the
        stage split: "lidar" -> {"lidar": encoder map}, "camera" -> {"camera":
        camera map (the lidar map without a camera branch), "lidar": ...},
        "fused" -> {"fused": fuser output}, "decoder" -> {"decoder": neck
        map}. The full forward returns the TransFusion head's dict, or
        {"center_preds": the CenterHead's list}, with ``seg_logits`` under
        ``with_map_seg`` and ``bev_feat``."""
        if stop_at not in STOP_AT:
            raise ValueError(f"stop_at={stop_at!r}: BEVFusion stops at {STOP_AT}")
        feats = []
        lidar = None
        if self.with_lidar:
            lidar = self._lidar(voxel_features, voxel_coords, voxel_valid, points, points_valid)
            feats.append(lidar)
        if stop_at == "lidar":
            return {"lidar": lidar}
        if self.with_camera:
            if images is None:
                raise ValueError("the camera branch needs images (and the camera keys "
                                 f"{CAMERA_TRANSFORMS})")
            cam = self._camera(images, depth_images, [camera[k] for k in CAMERA_TRANSFORMS])
            if lidar is not None and cam.shape[1:3] != lidar.shape[1:3]:
                cam = resize_bilinear(cam, lidar.shape[1:3])
            feats.insert(0, cam)
        if stop_at == "camera":
            return {"camera": feats[0], "lidar": lidar}
        fused = self.fuser(feats) if self.fuser is not None else feats[0]
        if stop_at == "fused":
            return {"fused": fused}
        bev = self.neck(self.decoder(fused))
        if stop_at == "decoder":
            return {"decoder": bev}
        preds = ({"center_preds": self.head(bev)} if self.head_type == "centerpoint"
                 else self.head(bev))
        if self.seg_head is not None:
            preds["seg_logits"] = self.seg_head(bev)
        preds["bev_feat"] = bev
        return preds

    def _lidar(self, voxel_features, voxel_coords, voxel_valid, points, points_valid):
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
        return self.encoder(sb)  # [B, H/8, W/8, 128 * 2]

    def _camera(self, images, depth_images, cam_args):
        """[B, Nc, iH, iW, 3] images -> camera BEV map [B, ny, nx, C]."""
        B, N = images.shape[:2]
        stages = self.camera_backbone(images.reshape(B * N, *images.shape[2:]).float())
        feat = self.camera_neck(stages)[0]
        feat = feat.reshape(B, N, *feat.shape[1:])
        cam_args = [a.float() for a in cam_args]
        if self.vtransform == "depth_lss":
            return self.camera_vtransform(feat, depth_images.float(), *cam_args)
        return self.camera_vtransform(feat, *cam_args)
