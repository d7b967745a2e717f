"""BEV map-segmentation head and its loss (port of
``dal3d_tpu/models/bevfusion/segm.py``).

Three bias-free 3x3 convs + BN + ReLU of width ``hidden`` on the fused BEV
map, then a 1x1 conv with bias to one logit per map class. NHWC in and out,
as the JAX module: ``seg_logits`` is [B, H, W, C] like ``bev_feat``; inside,
the convs run on the NCHW view (cuDNN, as JAX leaves them to its compiler).
Trained with the per-class mean sigmoid BCE against ``LoadBEVSegmentation``'s
masks (``data/pipelines/bev_seg.py``).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from ..layers import Conv2dBN
from ..losses.losses import sigmoid_cross_entropy_with_logits

SEG_CLASSES = ("drivable_area", "ped_crossing", "walkway", "stop_line", "carpark_area",
               "divider")


class BEVSegmentationHead(nn.Module):
    def __init__(self, in_channels: int, classes: Sequence[str] = SEG_CLASSES,
                 hidden: int = 128, num_convs: int = 3):
        super().__init__()
        self.classes = tuple(classes)
        self.convs = nn.Sequential(*(Conv2dBN(in_channels if i == 0 else hidden, hidden, 3,
                                              padding=1) for i in range(num_convs)))
        self.out = nn.Conv2d(hidden, len(self.classes), 1)

    def forward(self, bev: torch.Tensor) -> torch.Tensor:
        """bev [B, H, W, C] -> logits [B, H, W, len(classes)]."""
        return self.out(self.convs(bev.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)


def bev_segmentation_loss(logits: torch.Tensor, targets: torch.Tensor) -> Dict[str, torch.Tensor]:
    """logits / targets [B, H, W, C] -> {"loss": the per-class mean BCEs
    summed, "per_class": [C]}."""
    per_class = sigmoid_cross_entropy_with_logits(logits, targets).mean(dim=(0, 1, 2))
    return {"loss": per_class.sum(), "per_class": per_class}


def bev_segmentation_miou(logits: torch.Tensor, targets: torch.Tensor,
                          thresh: float = 0.5) -> torch.Tensor:
    """Per-class IoU [C] of sigmoid(logits) > thresh against targets > 0.5
    over the batch; 0 for a class absent from both."""
    pred = torch.sigmoid(logits) > thresh
    tgt = targets > 0.5
    inter = (pred & tgt).sum(dim=(0, 1, 2))
    union = (pred | tgt).sum(dim=(0, 1, 2))
    return torch.where(union > 0, inter / torch.clamp(union, min=1), 0.0)
