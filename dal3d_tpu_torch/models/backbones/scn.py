"""SECOND sparse middle backbone on every engine of JAX's
``FPNSpMiddleResNetFHD`` (port of ``dal3d_tpu/models/backbones/scn.py``).

Channel plan (as the reference):
  stem SubM(cin->16) -> 2x SparseBasicBlock(16) -> SparseConv s2 (16->32)
  -> 2x block(32) -> s2 (32->64)
  -> 2x block(64) -> s2 pad(0,1,1) (64->128)
  -> 2x block(128) -> k(3,1,1) s(2,1,1) (128->128)
  -> dense [B, H/8, W/8, 128*2], channel c*D + d

Engines (``impl``):
- ``"banded"``: voxels packed into bricks in y-major order; each level
  builds its plans once (brick grid, shared subm rulebook, downsample plan)
  on the tensor's device, and every conv is one pad gather and one conv
  gather of ops/banded.py (K1; K3 for the weight gradient), with brick
  capacities ``banded_caps``.
- ``"brick"``: JAX's non-banded brick engine: the same convs over bricks
  packed in order of appearance (``spatial=False``), capacities
  ``brick_caps``.
- ``"gather"`` (JAX's default engine for a config naming none): a
  ``SparseBatch`` of the voxels; each level builds its index grid once and
  shares it between the subm rulebook (with the gather-GEMM kernel's walk
  plan, made once for the level's convs) and the downsample. Every conv is
  one launch of ops/gather.py's gather-GEMM (K4), capacities ``voxel_caps``
  after each downsample.
- ``"hybrid"`` (the dataclass default of JAX's module): L0 on the gather
  engine, then ``to_dense_grid`` and levels 1-3 as masked dense 3D convs
  (ops/dense_sparse.py, cuDNN); only ``voxel_caps[0]`` caps anything.
- ``"dense"``: masked dense convs at every level, no caps. Its train-mode
  forward recomputes each L0 unit and each stage in backward
  (``layers.remat``): a full-width L0 grid is 2.75 GB a frame per tensor.

Every engine keeps its weights [K, Cin, Cout] under the same names
(``l0.stem``, ``l0.block{0,1}``, ``l0.down``, ``stage{1..3}``), so one
state dict loads into each. ``middle`` holds each level's output: a
BrickBatch, a SparseBatch, or a ``(dense, occ)`` tuple (hybrid levels 1-3,
dense everywhere), as in JAX. ``sorted_forward`` runs a gather backbone's
modules on the searchsorted engine's plans (ops/sparse.py), JAX's
sorted-order oracle.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ...ops import sparse as ss
from ...ops import sparse_backend as sp
from ...ops import sparse_brick as spb
from ...ops.dense_sparse import to_dense_grid
from ..layers import MaskedBatchNorm, SparseConvDown, SubMConv, remat

IMPLS = ("banded", "brick", "gather", "hybrid", "dense")
BRICK_WIDTHS_DEFAULT = (16, 16, 8, 4, 4)
BRICK_CAPS_DEFAULT = (48000, 17000, 10000, 6000, 6000)
BANDED_CAPS_DEFAULT = (48000, 17024, 9984, 6016, 6016)
VOXEL_CAPS_DEFAULT = (60000, 60000, 30000, 30000)


def brick_level_widths(W: int, widths) -> Tuple[int, ...]:
    """Per-level brick widths clamped to each level's W extent (the input
    level plus the 4 downsample outputs; stage3 strides depth only)."""
    wexts = (W, W // 2, W // 4, W // 8, W // 8)
    return tuple(min(int(b), max(we, 1)) for b, we in zip(widths, wexts))


def _bn_relu(bn: MaskedBatchNorm, x):
    if isinstance(x, tuple):
        dense, occ = x
        f = torch.relu(bn(dense, occ > 0))
        return f * occ[..., None].to(f.dtype), occ
    if isinstance(x, sp.SparseBatch):
        return x.replace(features=torch.relu(bn(x.features, x.valid)))
    f = torch.relu(bn(x.feat4(), x.vmask))
    return x.replace(features=f.reshape(x.features.shape))


def _level_plans(x):
    """(grid, subm rulebook) of a level, built once: the index grid and the
    rulebook with its walk plan (gather engine), the brick grid and the
    banded rulebook (brick engines), or none (dense compute)."""
    if isinstance(x, tuple):
        return None, None
    if isinstance(x, sp.SparseBatch):
        grid = sp.build_index_grid(x)
        return grid, sp.with_plan(sp.subm_rulebook(x, 3, grid))
    grid = spb.build_brick_grid(x)
    return grid, spb.subm_rulebook_banded(x, 3, grid)


class SparseBasicBlock(nn.Module):
    """Residual block of two SubM 3x3x3 convs, on a BrickBatch, a
    SparseBatch or a ``(dense, occ)`` tuple. det3d's blocks carry conv
    biases; the BEVFusion encoder's mmcv BasicBlock convs are bias-free
    (``use_bias=False``)."""

    def __init__(self, planes: int, dtype: torch.dtype, use_bias: bool = True):
        super().__init__()
        self.planes = planes
        self.conv1 = SubMConv(planes, planes, use_bias=use_bias, dtype=dtype)
        self.bn1 = MaskedBatchNorm(planes)
        self.conv2 = SubMConv(planes, planes, use_bias=use_bias, dtype=dtype)
        self.bn2 = MaskedBatchNorm(planes)

    def forward(self, x, rb=None):
        if isinstance(x, tuple):
            identity, occ = x
            mask = occ > 0
            out, _ = self.conv1(x)
            out, _ = self.conv2((torch.relu(self.bn1(out, mask)), occ))
            f = self.bn2(out, mask)
            return torch.relu(f + identity.to(f.dtype)) * occ[..., None].to(f.dtype), occ
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
    """Stem + 2 basic blocks + first downsample (JAX ``_BrickL0``,
    ``_L0GatherSection``, or the dense branch's inlined L0). ``checkpointed``:
    the stem (with its norm), each block and the downsample (with its norm)
    are recomputed in backward."""

    def __init__(self, cin: int, bw_out: int, out_cap: int, dtype: torch.dtype,
                 spatial: bool = True, checkpointed: bool = False):
        super().__init__()
        self.stem = SubMConv(cin, 16, use_bias=False, dtype=dtype)
        self.stem_bn = MaskedBatchNorm(16)
        self.block0 = SparseBasicBlock(16, dtype)
        self.block1 = SparseBasicBlock(16, dtype)
        self.down = SparseConvDown(16, 32, (3, 3, 3), (2, 2, 2), (1, 1, 1), out_cap,
                                   bw_out, dtype, spatial)
        self.down_bn = MaskedBatchNorm(32)
        self.checkpointed = checkpointed

    def forward(self, x):
        grid, rb = _level_plans(x)
        if self.checkpointed and self.training:
            x = remat(lambda v: _bn_relu(self.stem_bn, self.stem(v, rb)), x)
            x = remat(self.block1, remat(self.block0, x, rb), rb)
            return remat(lambda v: _bn_relu(self.down_bn, self.down(v, grid)), x)
        x = _bn_relu(self.stem_bn, self.stem(x, rb))
        x = self.block1(self.block0(x, rb), rb)
        return _bn_relu(self.down_bn, self.down(x, grid))


class Stage(nn.Module):
    """Two basic blocks at the current level, then a strided downsample
    (JAX ``_BrickStage`` / ``_Stage``). ``checkpointed``: the whole stage is
    recomputed in backward (JAX's ``_remat_stage``)."""

    def __init__(self, planes: int, out_planes: int, down_kernel, down_stride,
                 down_padding, bw_out: int, out_cap: int, dtype: torch.dtype,
                 spatial: bool = True, checkpointed: bool = False):
        super().__init__()
        self.block0 = SparseBasicBlock(planes, dtype)
        self.block1 = SparseBasicBlock(planes, dtype)
        self.down = SparseConvDown(planes, out_planes, down_kernel, down_stride,
                                   down_padding, out_cap, bw_out, dtype, spatial)
        self.down_bn = MaskedBatchNorm(out_planes)
        self.checkpointed = checkpointed

    def _run(self, x):
        grid, rb = _level_plans(x)
        x = self.block1(self.block0(x, rb), rb)
        return _bn_relu(self.down_bn, self.down(x, grid))

    def forward(self, x):
        if self.checkpointed and self.training:
            return remat(self._run, x)
        return self._run(x)


class FPNSpMiddleResNetFHD(nn.Module):
    """Sparse backbone on host voxels -> (dense BEV map [B, H/8, W/8, 256]
    f32, the 4 post-downsample levels). ``banded_caps`` / ``brick_caps``
    are the brick engines' capacities (input level + 4 downsamples),
    ``voxel_caps`` the per-voxel ones after each downsample (gather; hybrid
    uses the first alone, dense none)."""

    def __init__(self, sparse_shape: Sequence[int], num_input_features: int = 5,
                 dtype: torch.dtype = torch.float32,
                 brick_widths: Sequence[int] = BRICK_WIDTHS_DEFAULT,
                 banded_caps: Sequence[int] = BANDED_CAPS_DEFAULT, impl: str = "banded",
                 voxel_caps: Sequence[int] = VOXEL_CAPS_DEFAULT,
                 brick_caps: Sequence[int] = BRICK_CAPS_DEFAULT):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"unknown backbone impl {impl!r} (expected one of {IMPLS})")
        self.impl = impl
        self.sparse_shape = tuple(int(s) for s in sparse_shape)
        self.spatial = impl == "banded"
        if impl in ("banded", "brick"):
            self.widths = brick_level_widths(self.sparse_shape[2], brick_widths)
            self.caps = tuple(int(c) for c in (banded_caps if self.spatial else brick_caps))
            ws, caps = self.widths, self.caps[1:]
        else:
            self.widths = None
            self.caps = tuple(int(c) for c in voxel_caps)
            ws, caps = (0,) * 5, self.caps
        dense = impl == "dense"
        kw = dict(dtype=dtype, spatial=self.spatial, checkpointed=dense)
        self.l0 = Level0(num_input_features, ws[1], caps[0], **kw)
        self.stage1 = Stage(32, 64, (3, 3, 3), (2, 2, 2), (1, 1, 1), ws[2], caps[1], **kw)
        self.stage2 = Stage(64, 128, (3, 3, 3), (2, 2, 2), (0, 1, 1), ws[3], caps[2], **kw)
        self.stage3 = Stage(128, 128, (3, 1, 1), (2, 1, 1), (0, 0, 0), ws[4], caps[3], **kw)

    def forward(self, vf: torch.Tensor, vc: torch.Tensor, vv: torch.Tensor):
        """vf [B, N, F] voxel features, vc [B, N, 3] zyx coords, vv [B, N]:
        a brick pack for the brick engines, a SparseBatch (rows in voxel
        order) for the others, as JAX's ``voxelnet.py`` routes them."""
        if self.impl in ("banded", "brick"):
            x = spb.from_voxels(vf, vc, vv, self.sparse_shape, bw=self.widths[0],
                                mb_cap=self.caps[0], spatial=self.spatial)
        else:
            x = sp.from_voxels(vf, vc, vv, self.sparse_shape)
            if self.impl == "dense":
                x = to_dense_grid(x)
        middle = []
        for level in (self.l0, self.stage1, self.stage2, self.stage3):
            x = level(x)
            middle.append(x)
            if self.impl == "hybrid" and level is self.l0:
                x = to_dense_grid(x)
        return bev_map(x), middle


def bev_map(x) -> torch.Tensor:
    """The last level -> dense BEV map [B, H, W, C*D] f32, channel c*D + d."""
    if isinstance(x, tuple):
        d = x[0]
        B, D, H, W, C = d.shape
        return d.permute(0, 2, 3, 4, 1).reshape(B, H, W, C * D).float()
    if isinstance(x, sp.SparseBatch):
        return sp.to_dense(x).float()
    return spb.to_dense(x).float()


class SpMiddleResNetFHD(FPNSpMiddleResNetFHD):
    """The non-FPN variant: the dense BEV map alone, with JAX's defaults
    (``impl="hybrid"``, f32, ``voxel_caps`` (60000, 60000, 30000, 30000))."""

    def __init__(self, sparse_shape: Sequence[int], num_input_features: int = 5,
                 voxel_caps: Sequence[int] = VOXEL_CAPS_DEFAULT):
        super().__init__(sparse_shape, num_input_features, impl="hybrid",
                         voxel_caps=voxel_caps)

    def forward(self, vf: torch.Tensor, vc: torch.Tensor, vv: torch.Tensor) -> torch.Tensor:
        return super().forward(vf, vc, vv)[0]


def sorted_forward(backbone: FPNSpMiddleResNetFHD, vf: torch.Tensor, vc: torch.Tensor,
                   vv: torch.Tensor):
    """A gather backbone's modules and weights on the searchsorted engine's
    plans (ops/sparse.py: rows sorted by cell, binary-search rulebooks, each
    downsample's lowest ``voxel_caps`` cells), JAX's sorted-order oracle:
    the same 21 gather-GEMM convs as ``backbone.forward``. Returns (dense
    BEV map, middle)."""
    if backbone.impl != "gather":
        raise ValueError(f"sorted_forward runs a gather backbone, not {backbone.impl!r}")
    x = ss.from_voxels(vf, vc, vv, backbone.sparse_shape)
    middle = []
    for level in (backbone.l0, backbone.stage1, backbone.stage2, backbone.stage3):
        rb = sp.with_plan(ss.subm_rulebook(x, 3))
        if level is backbone.l0:
            x = _bn_relu(level.stem_bn, level.stem(x, rb))
        x = level.block1(level.block0(x, rb), rb)
        d = level.down
        x = ss.sparse_conv_downsample(x, d.weight.to(d.dtype), d.kernel_size, d.stride,
                                      d.padding, d.out_cap)
        x = _bn_relu(level.down_bn, x)
        middle.append(x)
    return bev_map(x), middle
