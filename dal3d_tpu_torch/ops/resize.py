"""Bilinear resize of NHWC maps, the twin of ``jax.image.resize(x, shape,
"bilinear")`` with its default ``antialias=True``.

JAX resizes through ``scale_and_translate``: per spatial axis a weight matrix
[in, out] of the triangle kernel, widened by 1 / scale when the axis shrinks
(antialiasing), each output column normalised to sum 1 and zeroed where the
sample falls outside the input; the axes are then contracted with the input.
``F.interpolate`` matches it for an upsample but not for an antialiased
downsample, so the port builds the same matrices (in f32, in JAX's order of
operations) and contracts them one axis at a time. An axis whose size does
not change is skipped, as JAX skips it.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


def weight_matrix(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] f32 weights of JAX's ``compute_weight_mat`` for the
    triangle kernel at scale out / in, translation 0, with antialiasing."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= f32(-0.5)) & (sample_f <= f32(in_size - 0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@lru_cache(maxsize=32)
def _weights(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    # made outside inference mode: a predict's cached matrix serves the train
    # step's autograd later
    with torch.inference_mode(False):
        return torch.from_numpy(weight_matrix(in_size, out_size)).to(device)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """x [B, H, W, C] -> [B, out_h, out_w, C] (f32), as ``jax.image.resize(x,
    (B, out_h, out_w, C), "bilinear")``."""
    H, W = x.shape[1:3]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if oh != H:
        x = torch.einsum("bhwc,ho->bowc", x, _weights(H, oh, x.device))
    if ow != W:
        x = torch.einsum("bhwc,wo->bhoc", x, _weights(W, ow, x.device))
    return x
