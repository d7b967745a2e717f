"""Training losses as plain tensor functions (port of
``dal3d_tpu/models/losses/losses.py``: the sigmoid focal loss, the weighted
smooth-L1 loss and the loss-weight normalisation of the CBGS head).

Parity note, as in the JAX module: the reference hard-disables per-code
weights, so ``code_weights`` apply only with ``use_code_weights=True``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def sigmoid_cross_entropy_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor,
                       gamma: float = 2.0, alpha: Optional[float] = 0.25) -> torch.Tensor:
    """Per-element focal loss [B, A, C]: logits / one-hot targets [B, A, C],
    weights [B, A]."""
    ce = sigmoid_cross_entropy_with_logits(logits, targets)
    p = torch.sigmoid(logits)
    p_t = targets * p + (1 - targets) * (1 - p)
    modulating = torch.pow(1.0 - p_t, gamma) if gamma else 1.0
    alpha_w = targets * alpha + (1 - targets) * (1 - alpha) if alpha is not None else 1.0
    return modulating * alpha_w * ce * weights[..., None]


def weighted_smooth_l1(preds: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor,
                       sigma: float = 3.0, code_weights: Optional[Sequence[float]] = None,
                       use_code_weights: bool = False) -> torch.Tensor:
    """Per-element smooth-L1 [B, A, code] (the codewise path)."""
    diff = preds - targets
    if use_code_weights and code_weights is not None:
        diff = diff * torch.as_tensor(code_weights, dtype=diff.dtype, device=diff.device)
    abs_diff = torch.abs(diff)
    lt = (abs_diff <= 1.0 / (sigma ** 2)).to(diff.dtype)
    loss = lt * 0.5 * torch.square(abs_diff * sigma) + (abs_diff - 0.5 / (sigma ** 2)) * (1.0 - lt)
    return loss * weights[..., None]


def prepare_loss_weights(labels: torch.Tensor, pos_cls_weight: float = 1.0,
                         neg_cls_weight: float = 2.0,
                         norm_type: str = "norm_by_num_positives"):
    """Per-sample cls / reg weight normalisation, the reference's LossNormType
    matrix. labels [B, A] int (-1 = ignore). Returns (cls_weights,
    reg_weights, cared).

    - norm_by_num_positives (the CBGS configs' choice): cls and reg divided
      by the positive count,
    - norm_by_num_examples: cls by the cared (non-ignore) count, reg by the
      positive count,
    - norm_by_num_pos_neg: cls per anchor by its own class's count (positives
      by num_pos, negatives by num_neg), reg by the positive count,
    - dont_norm: reg by the positive count, cls unnormalised."""
    positives = labels > 0
    negatives = labels == 0
    cls_weights = negatives.float() * neg_cls_weight + positives.float() * pos_cls_weight
    reg_weights = positives.float()
    cared = labels >= 0
    pos_normalizer = torch.clamp(positives.sum(dim=1, keepdim=True).float(), min=1.0)
    if norm_type == "norm_by_num_positives":
        reg_weights = reg_weights / pos_normalizer
        cls_weights = cls_weights / pos_normalizer
    elif norm_type == "norm_by_num_examples":
        num_examples = torch.clamp(cared.sum(dim=1, keepdim=True).float(), min=1.0)
        cls_weights = cls_weights / num_examples
        reg_weights = reg_weights / pos_normalizer
    elif norm_type == "norm_by_num_pos_neg":
        pos_neg = torch.stack([positives, negatives], dim=-1).float()  # [B, A, 2]
        normalizer = pos_neg.sum(dim=1, keepdim=True)  # [B, 1, 2]
        cls_normalizer = torch.clamp((pos_neg * normalizer).sum(-1), min=1.0)  # [B, A]
        reg_weights = reg_weights / torch.clamp(normalizer[:, :, 0], min=1.0)
        cls_weights = cls_weights / cls_normalizer
    elif norm_type == "dont_norm":
        reg_weights = reg_weights / pos_normalizer
    else:
        raise ValueError(f"unknown loss norm type {norm_type!r}")
    return cls_weights, reg_weights, cared
