"""The standard image FPN (port of ``dal3d_tpu/models/necks/fpn.py``; the
reference's det3d/models/necks/fpn.py:11, registered there but used by no
active config).

NHWC maps in and out, as the JAX module: a 1x1 lateral conv a level, the
top-down sum with JAX's nearest resize (``jax.image.resize(...,
"nearest")``: source index floor((i + 0.5) * in / out) in f32), then a 3x3
conv a level. The convs are ``nn.Conv2d`` with bias (flax's default) on the
NCHW view."""
from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn


def resize_nearest(x: torch.Tensor, hw) -> torch.Tensor:
    """x [B, H, W, C] -> [B, h, w, C] by ``jax.image.resize``'s nearest
    rule, per spatial axis that changes size."""
    for axis, n in ((1, int(hw[0])), (2, int(hw[1]))):
        m = x.shape[axis]
        if m == n:
            continue
        src = torch.floor((torch.arange(n, dtype=torch.float32, device=x.device) + 0.5)
                          * m / n).long()
        x = x.index_select(axis, src)
    return x


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256, num_outs: int = 4):
        super().__init__()
        self.num_outs = num_outs
        self.lateral = nn.ModuleList(nn.Conv2d(c, out_channels, 1) for c in in_channels)
        self.out = nn.ModuleList(nn.Conv2d(out_channels, out_channels, 3, padding=1)
                                 for _ in in_channels)

    def forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """NHWC maps, finest first -> the first ``num_outs`` NHWC outputs."""
        laterals = [conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
                    for conv, x in zip(self.lateral, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_nearest(laterals[i],
                                                               laterals[i - 1].shape[1:3])
        outs = [conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
                for conv, x in zip(self.out, laterals)]
        return outs[: self.num_outs]
