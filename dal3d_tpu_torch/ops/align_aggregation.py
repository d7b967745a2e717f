"""Feature alignment and aggregation (port of
``dal3d_tpu/ops/align_aggregation.py``; the reference's det3d/ops/
align_aggregation ``correlation`` and ``alignfeature`` extensions and
``align_feature_and_aggregation.py``), NCHW, plain PyTorch:

- ``local_correlation``: the K x K patch correlation of two maps (kernel 1,
  stride 1, unit dilation: the settings the reference module uses),
  out[b, o, y, x] = <f1[b, :, y, x], f2 shifted by offset o>;
- ``align_feature``: the per-pixel weighted blend of the K x K shifted
  neighbourhood, out[b, c, y, x] = sum_o w[b, o, y, x] feat_o[b, c, y, x];
- ``AlignFeatureAggregation``: the module (1x1 embeddings, softmaxed
  correlation weights, alignment, and the blend of aligned and current
  features by one conv tower applied to both).

Offsets o = (dy, dx) run row-major over [-r, r]^2, r = K // 2, zero outside
the map, as JAX's. Both ops accumulate over the offsets one shifted view at
a time instead of stacking all K^2 (at K = 9 on a 128 x 128 x 384 BEV map
the stack would take 2 GB).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["local_correlation", "align_feature", "AlignFeatureAggregation"]


def _shifted_views(x: torch.Tensor, patch: int):
    """The K*K zero-padded shifted views of x [B, C, H, W], row-major over
    the offsets."""
    r = patch // 2
    H, W = x.shape[-2:]
    xp = F.pad(x, (r, r, r, r))
    for dy in range(patch):
        for dx in range(patch):
            yield xp[:, :, dy:dy + H, dx:dx + W]


def local_correlation(f1: torch.Tensor, f2: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, C, H, W] x2 -> [B, patch*patch, H, W]: the plain dot of f1 with
    each shifted f2 (the reference kernel divides by the kernel's element
    count, 1 here)."""
    if patch % 2 != 1:
        raise ValueError(f"local_correlation: patch must be odd, got {patch}")
    return torch.stack([(f1 * v).sum(dim=1) for v in _shifted_views(f2, patch)], dim=1)


def align_feature(feat: torch.Tensor, weights: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, C, H, W], [B, patch*patch, H, W] -> [B, C, H, W] weighted blend
    of the shifted neighbourhood."""
    out = torch.zeros_like(feat)
    for o, v in enumerate(_shifted_views(feat, patch)):
        out = out + weights[:, o:o + 1] * v
    return out


class AlignFeatureAggregation(nn.Module):
    """Align_Feature_and_Aggregation (reference
    align_feature_and_aggregation.py:31-60): embed both maps with 1x1 convs
    to 64 channels, softmax their local correlation into alignment weights,
    align the keyframe's features, then blend aligned and current by a
    2-way softmax of one conv tower (1x1 -> 64, 3x3 -> 32, 1x1 -> 1) applied
    with the same weights to both. Inputs and output [B, num_channel, H, W]."""

    def __init__(self, num_channel: int, neighbor: int = 9):
        super().__init__()
        self.neighbor = neighbor
        self.embed_keyframe = nn.Conv2d(num_channel, 64, 1)
        self.embed_current = nn.Conv2d(num_channel, 64, 1)
        self.agg_conv1 = nn.Conv2d(num_channel, 64, 1)
        self.agg_conv2 = nn.Conv2d(64, 32, 3, padding=1)
        self.agg_conv3 = nn.Conv2d(32, 1, 1)

    def _score(self, x: torch.Tensor) -> torch.Tensor:
        return self.agg_conv3(self.agg_conv2(self.agg_conv1(x)))

    def forward(self, feature_select: torch.Tensor, feature_current: torch.Tensor) -> torch.Tensor:
        w = local_correlation(self.embed_current(feature_current),
                              self.embed_keyframe(feature_select), self.neighbor)
        aligned = align_feature(feature_select, torch.softmax(w, dim=1), self.neighbor)
        blend = torch.softmax(torch.cat([self._score(aligned), self._score(feature_current)],
                                        dim=1), dim=1)
        return blend[:, :1] * aligned + blend[:, 1:] * feature_current
