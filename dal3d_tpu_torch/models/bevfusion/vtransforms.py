"""LSS view transforms: image features (+ lidar depth) -> camera BEV map
(port of ``dal3d_tpu/models/bevfusion/vtransforms.py``).

- ``create_frustum`` / ``get_geometry``: the (u, v, depth) samples of each
  feature pixel and depth bin, through the inverse image augmentation and
  the inverse intrinsics, into the (augmented) lidar frame;
- ``DepthLSSTransform``: a depth branch on the rasterised lidar depth image
  (1 -> 8 1x1, 8 -> 32 5x5 / 4, 32 -> 64 5x5 / 2), concatenated before the
  image features, then the depthnet (two 3x3 convs + BN + ReLU and a 1x1
  conv) predicts D depth bins + C context channels;
- ``LSSTransform``: the camera-only variant, one 1x1 depthnet on the image
  features;
- both splat the softmax(depth) x context outer product into the BEV grid
  with ``ops/bev_pool.py`` and downsample the grid 2x (three bias-free 3x3
  convs + BN + ReLU, the middle one at stride 2).

NHWC in and out; the convs run on the NCHW view. The outer product is the
largest tensor of the camera branch (1.28 GB at B=2 with 6 cameras at
256 x 704: 118 bins x 80 channels over 12 x 32 x 88 pixels). It is made once
in the layout the product gives, [B, N, fH, fW, D, C], and never copied: the
geometry is computed in that order instead (JAX computes it in
[B, N, D, fH, fW] order and transposes the features), so the scatter adds
the same points in another order.

The cell of a point is ``floor`` of its f32 geometry. ``torch.linalg.inv``
and ``jnp.linalg.inv`` round differently, so a point within rounding of a
cell edge can land in the neighbouring cell on either side
(``tests/test_torch_camera_branch.py`` counts them).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...ops.bev_pool import bev_pool_batched
from ..layers import Conv2dBN

XBOUND = (-54.0, 54.0, 0.3)
YBOUND = (-54.0, 54.0, 0.3)
ZBOUND = (-10.0, 10.0, 20.0)
DBOUND = (1.0, 60.0, 0.5)


def gen_dx_bx(xbound, ybound, zbound):
    """Cell size, first cell centre and cell count per axis (x, y, z)."""
    dx = np.array([row[2] for row in (xbound, ybound, zbound)], np.float32)
    bx = np.array([row[0] + row[2] / 2.0 for row in (xbound, ybound, zbound)], np.float32)
    nx = np.array([round((row[1] - row[0]) / row[2]) for row in (xbound, ybound, zbound)],
                  np.int64)
    return dx, bx, nx


def create_frustum(image_size, feature_size, dbound) -> np.ndarray:
    """[D, fH, fW, 3] of (u, v, depth) image-plane sample points."""
    iH, iW = image_size
    fH, fW = feature_size
    ds = np.arange(*dbound, dtype=np.float32)
    xs = np.linspace(0, iW - 1, fW, dtype=np.float32)
    ys = np.linspace(0, iH - 1, fH, dtype=np.float32)
    return np.stack(np.broadcast_arrays(xs[None, None, :], ys[None, :, None],
                                        ds[:, None, None]), axis=-1)


def get_geometry(frustum: torch.Tensor, camera2lidar_rots: torch.Tensor,
                 camera2lidar_trans: torch.Tensor, intrins: torch.Tensor,
                 post_rots: torch.Tensor, post_trans: torch.Tensor) -> torch.Tensor:
    """frustum [d0, d1, d2, 3] (any order of the depth and pixel axes) and
    per-camera [B, N, 3, 3] / [B, N, 3] transforms -> [B, N, d0, d1, d2, 3]
    lidar-frame xyz."""
    points = frustum[None, None] - post_trans[:, :, None, None, None, :]
    points = torch.einsum("bnij,bndhwj->bndhwi", torch.linalg.inv(post_rots), points)
    points = torch.cat([points[..., :2] * points[..., 2:3], points[..., 2:3]], dim=-1)
    combine = torch.einsum("bnij,bnjk->bnik", camera2lidar_rots, torch.linalg.inv(intrins))
    points = torch.einsum("bnij,bndhwj->bndhwi", combine, points)
    return points + camera2lidar_trans[:, :, None, None, None, :]


def splat(feats: torch.Tensor, cam_args: Sequence[torch.Tensor], image_size, dbound,
          xbound, ybound, zbound) -> torch.Tensor:
    """feats [B, N, fH, fW, D, C] (the depth-weighted context) -> BEV
    [B, ny, nx, C * nz] through the frustum geometry and ``bev_pool``."""
    B, N, fH, fW, D, C = feats.shape
    frustum = torch.from_numpy(create_frustum(image_size, (fH, fW), dbound)).to(feats.device)
    geom = get_geometry(frustum.permute(1, 2, 0, 3), *cam_args)  # [B, N, fH, fW, D, 3]
    dx, bx, nx = gen_dx_bx(xbound, ybound, zbound)
    dx_t = torch.from_numpy(dx).to(feats.device)
    lo = torch.from_numpy(bx).to(feats.device) - dx_t / 2.0
    coords = torch.floor((geom - lo) / dx_t).to(torch.int32).reshape(B, -1, 3)
    valid = ((coords >= 0) & (coords < torch.from_numpy(nx.astype(np.int32)).to(
        feats.device))).all(-1)
    return bev_pool_batched(feats.reshape(B, -1, C), coords, valid,
                            int(nx[0]), int(nx[1]), int(nx[2]))


def depth_context(x: torch.Tensor, D: int) -> torch.Tensor:
    """The depthnet's NCHW output [B*N, D + C, fH, fW] -> softmax over the D
    bins times the C context channels, [B*N, fH, fW, D, C]."""
    x = x.permute(0, 2, 3, 1)
    depth = torch.softmax(x[..., :D], dim=-1)
    return depth[..., None] * x[..., None, D:]


class BEVDownsample2x(nn.Sequential):
    """Three bias-free 3x3 convs + BN + ReLU, the middle one at stride 2."""

    def __init__(self, channels: int):
        super().__init__(Conv2dBN(channels, channels, 3, padding=1),
                         Conv2dBN(channels, channels, 3, stride=2, padding=1),
                         Conv2dBN(channels, channels, 3, padding=1))


class _LSSBase(nn.Module):
    def __init__(self, out_channels: int, image_size, xbound, ybound, zbound, dbound,
                 downsample: int):
        super().__init__()
        if downsample not in (1, 2):
            raise ValueError(f"downsample={downsample}: the LSS transforms downsample 1x or 2x")
        self.C = out_channels
        self.D = len(np.arange(*dbound))
        self.image_size = tuple(image_size)
        self.bounds = (tuple(dbound), tuple(xbound), tuple(ybound), tuple(zbound))
        self.downsample = BEVDownsample2x(out_channels) if downsample == 2 else None

    def _bev(self, feats: torch.Tensor, cam_args) -> torch.Tensor:
        bev = splat(feats, cam_args, self.image_size, *self.bounds)  # [B, ny, nx, C*nz]
        if self.downsample is not None:
            bev = self.downsample(bev.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return bev


class DepthLSSTransform(_LSSBase):
    def __init__(self, in_channels: int = 256, out_channels: int = 80,
                 image_size: Tuple[int, int] = (256, 704), xbound=XBOUND, ybound=YBOUND,
                 zbound=ZBOUND, dbound=DBOUND, downsample: int = 2):
        super().__init__(out_channels, image_size, xbound, ybound, zbound, dbound, downsample)
        self.dtransform = nn.Sequential(Conv2dBN(1, 8, 1, bias=True),
                                        Conv2dBN(8, 32, 5, stride=4, padding=2, bias=True),
                                        Conv2dBN(32, 64, 5, stride=2, padding=2, bias=True))
        self.depthnet = nn.Sequential(
            Conv2dBN(in_channels + 64, in_channels, 3, padding=1, bias=True),
            Conv2dBN(in_channels, in_channels, 3, padding=1, bias=True))
        self.depth_out = nn.Conv2d(in_channels, self.D + out_channels, 1)

    def forward(self, img_feats: torch.Tensor, depth_img: torch.Tensor, *cam_args):
        """img_feats [B, N, fH, fW, Cin]; depth_img [B, N, iH, iW, 1]; cam_args:
        camera2lidar rots [B, N, 3, 3], trans [B, N, 3], intrinsics [B, N, 3,
        3], image-augmentation rots [B, N, 3, 3], trans [B, N, 3] -> BEV [B, ny,
        nx, C] (ny, nx halved by the downsample)."""
        B, N, fH, fW, Cin = img_feats.shape
        d = self.dtransform(depth_img.reshape(B * N, *depth_img.shape[2:]).permute(0, 3, 1, 2))
        x = torch.cat([d, img_feats.reshape(B * N, fH, fW, Cin).permute(0, 3, 1, 2)], dim=1)
        x = self.depth_out(self.depthnet(x))
        feats = depth_context(x, self.D).reshape(B, N, fH, fW, self.D, self.C)
        return self._bev(feats, cam_args)


class LSSTransform(_LSSBase):
    """The camera-only view transform: no depth branch, one 1x1 depthnet."""

    def __init__(self, in_channels: int = 256, out_channels: int = 80,
                 image_size: Tuple[int, int] = (256, 704), xbound=XBOUND, ybound=YBOUND,
                 zbound=ZBOUND, dbound=DBOUND, downsample: int = 2):
        super().__init__(out_channels, image_size, xbound, ybound, zbound, dbound, downsample)
        self.depth_out = nn.Conv2d(in_channels, self.D + out_channels, 1)

    def forward(self, img_feats: torch.Tensor, *cam_args):
        B, N, fH, fW, Cin = img_feats.shape
        x = self.depth_out(img_feats.reshape(B * N, fH, fW, Cin).permute(0, 3, 1, 2))
        feats = depth_context(x, self.D).reshape(B, N, fH, fW, self.D, self.C)
        return self._bev(feats, cam_args)
