"""SECOND sparse middle backbone on the banded brick engine or the gather
engine (port of the brick/banded and gather branches of
``dal3d_tpu/models/backbones/scn.py``).

Channel plan (as the reference):
  stem SubM(cin->16) -> 2x SparseBasicBlock(16) -> SparseConv s2 (16->32)
  -> 2x block(32) -> s2 (32->64)
  -> 2x block(64) -> s2 pad(0,1,1) (64->128)
  -> 2x block(128) -> k(3,1,1) s(2,1,1) (128->128)
  -> dense [B, H/8, W/8, 128*2], channel c*D + d

``impl="banded"``: voxels packed into bricks; each level builds its plans
once (brick grid, shared subm rulebook, downsample plan) on the tensor's
device, and every conv is one pad gather and one conv gather of
ops/banded.py. ``impl="gather"`` (JAX's default engine): a ``SparseBatch``
of the voxels; each level builds its index grid once and shares it between
the subm rulebook (which carries the gather-GEMM kernel's walk plan, made
once for the level's convs) and the downsample, as BEVFusion's encoder does
(JAX builds the grid twice; the plans are the same). Every conv is one
launch of ops/gather.py's gather-GEMM, with capacities ``voxel_caps`` after
each downsample. Both engines keep their weights [K, Cin, Cout] under the
same names (``l0.stem``, ``l0.block{0,1}``, ``l0.down``, ``stage{1..3}``),
so one state dict loads into either.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ...ops import sparse_backend as sp
from ...ops import sparse_brick as spb
from ..layers import MaskedBatchNorm, SparseConvDown, SubMConv

IMPLS = ("banded", "gather")
BRICK_WIDTHS_DEFAULT = (16, 16, 8, 4, 4)
BANDED_CAPS_DEFAULT = (48000, 17024, 9984, 6016, 6016)
VOXEL_CAPS_DEFAULT = (60000, 60000, 30000, 30000)


def brick_level_widths(W: int, widths) -> Tuple[int, ...]:
    """Per-level brick widths clamped to each level's W extent (the input
    level plus the 4 downsample outputs; stage3 strides depth only)."""
    wexts = (W, W // 2, W // 4, W // 8, W // 8)
    return tuple(min(int(b), max(we, 1)) for b, we in zip(widths, wexts))


def _bn_relu(bn: MaskedBatchNorm, x):
    if isinstance(x, sp.SparseBatch):
        return x.replace(features=torch.relu(bn(x.features, x.valid)))
    f = torch.relu(bn(x.feat4(), x.vmask))
    return x.replace(features=f.reshape(x.features.shape))


def _level_plans(x):
    """(grid, subm rulebook) of a level, built once: the index grid and the
    rulebook with its walk plan (gather engine), or the brick grid and the
    banded rulebook."""
    if isinstance(x, sp.SparseBatch):
        grid = sp.build_index_grid(x)
        return grid, sp.with_plan(sp.subm_rulebook(x, 3, grid))
    grid = spb.build_brick_grid(x)
    return grid, spb.subm_rulebook_banded(x, 3, grid)


class SparseBasicBlock(nn.Module):
    """Residual block of two SubM 3x3x3 convs, on a BrickBatch or a
    SparseBatch. det3d's blocks carry conv biases; the BEVFusion encoder's
    mmcv BasicBlock convs are bias-free (``use_bias=False``)."""

    def __init__(self, planes: int, dtype: torch.dtype, use_bias: bool = True):
        super().__init__()
        self.planes = planes
        self.conv1 = SubMConv(planes, planes, use_bias=use_bias, dtype=dtype)
        self.bn1 = MaskedBatchNorm(planes)
        self.conv2 = SubMConv(planes, planes, use_bias=use_bias, dtype=dtype)
        self.bn2 = MaskedBatchNorm(planes)

    def forward(self, x, rb):
        identity = x.features
        if isinstance(x, sp.SparseBatch):
            out = self.conv1(x, rb)
            out = self.conv2(out.replace(features=torch.relu(self.bn1(out.features, out.valid))),
                             rb)
            f = torch.relu(self.bn2(out.features, out.valid) + identity)
            return out.replace(features=torch.where(
                out.valid[..., None], f, torch.zeros((), dtype=f.dtype, device=f.device)))
        out = _bn_relu(self.bn1, self.conv1(x, rb))
        out = self.conv2(out, rb)
        f = self.bn2(out.feat4(), out.vmask)
        f = torch.relu(f.reshape(out.features.shape) + identity)
        keep = out.vmask.repeat_interleave(self.planes, dim=-1)
        return out.replace(features=torch.where(keep, f, torch.zeros((), dtype=f.dtype,
                                                                     device=f.device)))


class Level0(nn.Module):
    """Stem + 2 basic blocks + first downsample (JAX ``_BrickL0``, or the
    gather branch's inlined L0)."""

    def __init__(self, cin: int, bw_out: int, out_cap: int, dtype: torch.dtype):
        super().__init__()
        self.stem = SubMConv(cin, 16, use_bias=False, dtype=dtype)
        self.stem_bn = MaskedBatchNorm(16)
        self.block0 = SparseBasicBlock(16, dtype)
        self.block1 = SparseBasicBlock(16, dtype)
        self.down = SparseConvDown(16, 32, (3, 3, 3), (2, 2, 2), (1, 1, 1), out_cap,
                                   bw_out, dtype)
        self.down_bn = MaskedBatchNorm(32)

    def forward(self, x):
        grid, rb = _level_plans(x)
        x = _bn_relu(self.stem_bn, self.stem(x, rb))
        x = self.block1(self.block0(x, rb), rb)
        return _bn_relu(self.down_bn, self.down(x, grid))


class Stage(nn.Module):
    """Two basic blocks at the current level, then a strided downsample
    (JAX ``_BrickStage`` / ``_Stage``)."""

    def __init__(self, planes: int, out_planes: int, down_kernel, down_stride,
                 down_padding, bw_out: int, out_cap: int, dtype: torch.dtype):
        super().__init__()
        self.block0 = SparseBasicBlock(planes, dtype)
        self.block1 = SparseBasicBlock(planes, dtype)
        self.down = SparseConvDown(planes, out_planes, down_kernel, down_stride,
                                   down_padding, out_cap, bw_out, dtype)
        self.down_bn = MaskedBatchNorm(out_planes)

    def forward(self, x):
        grid, rb = _level_plans(x)
        x = self.block1(self.block0(x, rb), rb)
        return _bn_relu(self.down_bn, self.down(x, grid))


class FPNSpMiddleResNetFHD(nn.Module):
    """Sparse backbone on host voxels -> (dense BEV map [B, H/8, W/8, 256]
    f32, the 4 post-downsample sparse tensors: BrickBatches on the banded
    engine, SparseBatches on the gather engine). ``caps`` are the banded
    engine's brick capacities (input level + 4 downsamples) or the gather
    engine's ``voxel_caps`` (4 downsamples)."""

    def __init__(self, sparse_shape: Sequence[int], num_input_features: int = 5,
                 dtype: torch.dtype = torch.float32,
                 brick_widths: Sequence[int] = BRICK_WIDTHS_DEFAULT,
                 banded_caps: Sequence[int] = BANDED_CAPS_DEFAULT, impl: str = "banded",
                 voxel_caps: Sequence[int] = VOXEL_CAPS_DEFAULT):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"unknown backbone impl {impl!r} (expected one of {IMPLS})")
        self.impl = impl
        self.sparse_shape = tuple(int(s) for s in sparse_shape)
        if impl == "banded":
            self.widths = brick_level_widths(self.sparse_shape[2], brick_widths)
            self.caps = tuple(int(c) for c in banded_caps)
            ws, caps = self.widths, self.caps[1:]
        else:
            self.widths = None
            self.caps = tuple(int(c) for c in voxel_caps)
            ws, caps = (0,) * 5, self.caps
        self.l0 = Level0(num_input_features, ws[1], caps[0], dtype)
        self.stage1 = Stage(32, 64, (3, 3, 3), (2, 2, 2), (1, 1, 1), ws[2], caps[1], dtype)
        self.stage2 = Stage(64, 128, (3, 3, 3), (2, 2, 2), (0, 1, 1), ws[3], caps[2], dtype)
        self.stage3 = Stage(128, 128, (3, 1, 1), (2, 1, 1), (0, 0, 0), ws[4], caps[3], dtype)

    def forward(self, vf: torch.Tensor, vc: torch.Tensor, vv: torch.Tensor):
        """vf [B, N, F] voxel features, vc [B, N, 3] zyx coords, vv [B, N]."""
        if self.impl == "gather":
            x = sp.from_voxels(vf, vc, vv, self.sparse_shape)
            to_dense = sp.to_dense
        else:
            x = spb.from_voxels(vf, vc, vv, self.sparse_shape, bw=self.widths[0],
                                mb_cap=self.caps[0])
            to_dense = spb.to_dense
        middle = []
        for level in (self.l0, self.stage1, self.stage2, self.stage3):
            x = level(x)
            middle.append(x)
        return to_dense(x).float(), middle
