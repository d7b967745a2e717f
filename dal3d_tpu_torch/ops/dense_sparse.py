"""Dense compute with sparse semantics (port of
``dal3d_tpu/ops/dense_sparse.py``): the ``hybrid`` engine's levels 1-3 and
the ``dense`` engine's every level.

Voxels are scattered once into a dense grid [B, D, H, W, C] with an
occupancy grid [B, D, H, W] (1 where a site is active, in the features'
dtype); every SubM conv is a dense 3D conv masked by the occupancy, and a
strided conv's output is active where any input of its window is (spconv's
output-set rule). Inactive cells stay exactly zero, so masked batch-norm
statistics and residual adds are those of the gather engine.

The grids keep JAX's logical [B, D, H, W, C] shape, as views of
[B, C, D, H, W] contiguous tensors: cuDNN's f32 3D convs on the H100 run
NCDHW kernels, and fed ``channels_last_3d`` they transpose every operand and
take far slower weight gradients at L0 (``tools/dense_conv_ab.py``). cuDNN
picks each algorithm by its heuristic, TF32 off (``_Conv3d``). Each
conv is one ``F.conv3d`` (cuDNN on the card) on ``x.permute(0, 4, 1, 2,
3)``, which is then contiguous: no copy is made, and the output permutes
back to the logical shape as a view; the elementwise ops keep the layout
of their grid operand. JAX slices the depth axis into 2D convs (a
workaround for its TPU compiler); the port runs the 3D conv whole. The
occupancy dilation is ``F.max_pool3d`` (its padding is -inf, so a window
is active iff one of its inputs is), JAX's 27 shifted-slice maxima in one
op. f32 results equal JAX's up to the summation order; in bf16 cuDNN rounds
each output once where JAX rounds every depth slice's partial sum.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .sparse import SparseBatch, _triple


def to_dense_grid(sb: SparseBatch) -> Tuple[torch.Tensor, torch.Tensor]:
    """SparseBatch -> (dense [B, D, H, W, C], occupancy [B, D, H, W] in the
    features' dtype). The dense grid is a view of a [B, C, D, H, W]
    contiguous tensor (cuDNN's layout for its f32 3D convs). Rows are added
    into zeros (padding rows add 0 to cell 0), so no index repeats a
    nonzero value and the result is exact."""
    B, N, C = sb.features.shape
    D, H, W = sb.shape
    cells = D * H * W
    dev, dt = sb.features.device, sb.features.dtype
    valid = sb.valid
    b = torch.arange(B, device=dev)[:, None].expand(B, N).reshape(-1)
    lin = torch.where(valid, sb.lin.long(), 0).reshape(-1)
    feats = torch.where(valid[..., None], sb.features, torch.zeros((), dtype=dt, device=dev))
    dense = torch.zeros(B, C, cells, dtype=dt, device=dev)
    dense.permute(0, 2, 1).index_put_((b, lin), feats.reshape(B * N, C), accumulate=True)
    occ = torch.zeros(B, cells, dtype=dt, device=dev)
    occ.index_put_((b, lin), valid.reshape(-1).to(dt), accumulate=True)
    return dense.view(B, C, D, H, W).permute(0, 2, 3, 4, 1), occ.view(B, D, H, W)


def _heuristic():
    """cuDNN with its heuristic algorithm choice and TF32 off."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False,
                                      allow_tf32=False)


class _Conv3d(torch.autograd.Function):
    """``F.conv3d`` whose forward and both gradients take cuDNN's heuristic
    choice, whatever the caller's flags (the steps autotune their 2D convs):
    the autotuner's one-time search of the full-width L0 shapes takes about
    two minutes, and its picks match the heuristic's at every forward and
    at levels 1-3 (``tools/dense_conv_ab.py``)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        with _heuristic():
            return F.conv3d(x, w, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with _heuristic():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, list(ctx.stride), list(ctx.padding), [1, 1, 1], False,
                [0, 0, 0], 1, [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None


def _conv3d(x: torch.Tensor, weights: torch.Tensor, kernel_size, stride,
            padding) -> torch.Tensor:
    """x [B, D, H, W, Cin], weights [K, Cin, Cout] (z-major taps, cast to x's
    dtype) -> [B, Do, Ho, Wo, Cout] in x's dtype: one cross-correlation,
    out[o] = sum_k x[s*o - p + k] @ w[k], as JAX's convolution."""
    kd, kh, kw = _triple(kernel_size)
    w = weights.to(x.dtype).reshape(kd, kh, kw, weights.shape[1], weights.shape[2])
    w = w.permute(4, 3, 0, 1, 2).contiguous()
    out = _Conv3d.apply(x.permute(0, 4, 1, 2, 3), w, _triple(stride), _triple(padding))
    return out.permute(0, 2, 3, 4, 1)


def subm_conv_dense(x: torch.Tensor, occ: torch.Tensor, weights: torch.Tensor,
                    kernel_size=3) -> torch.Tensor:
    """Submanifold conv: the dense conv masked to the input's active set.
    x [B, D, H, W, Cin], occ [B, D, H, W], weights [K, Cin, Cout]."""
    ks = _triple(kernel_size)
    out = _conv3d(x, weights, ks, 1, tuple(k // 2 for k in ks))
    return out * occ[..., None].to(out.dtype)


def dilate_occupancy(occ: torch.Tensor, kernel_size, stride, padding) -> torch.Tensor:
    """occ [B, D, H, W] -> the strided conv's output occupancy (1 where any
    input of the window is active), in occ's dtype."""
    o = F.max_pool3d(occ[:, None], _triple(kernel_size), _triple(stride), _triple(padding))
    return (o[:, 0] > 0).to(occ.dtype)


def sparse_conv_down_dense(x: torch.Tensor, occ: torch.Tensor, weights: torch.Tensor,
                           kernel_size, stride, padding) -> Tuple[torch.Tensor, torch.Tensor]:
    """Strided sparse conv: the dense strided conv masked by the dilated
    occupancy. Returns (out, occ_out)."""
    out = _conv3d(x, weights, kernel_size, stride, padding)
    occ_out = dilate_occupancy(occ, kernel_size, stride, padding)
    return out * occ_out[..., None].to(out.dtype), occ_out


def masked_mean_var(x: torch.Tensor, occ: torch.Tensor):
    """Batch-norm statistics over the active cells only, in f32: (mean [C],
    biased var [C]); the count is clamped to 1."""
    m = occ[..., None].float()
    cnt = torch.clamp(m.sum(), min=1.0)
    xf = x.float()
    dims = tuple(range(x.ndim - 1))
    mean = (xf * m).sum(dims) / cnt
    var = (torch.square(xf - mean) * m).sum(dims) / cnt
    return mean, var
