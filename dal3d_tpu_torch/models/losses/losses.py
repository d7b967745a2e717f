"""Training losses as plain tensor functions (port of
``dal3d_tpu/models/losses/losses.py``: the sigmoid focal loss, the weighted
smooth-L1 loss and the loss-weight normalisation of the CBGS head; the
softmax cross-entropy, balanced-L1, GHM classification and IoU regression
losses of the partial-label heads).

Parity note, as in the JAX module: the reference hard-disables per-code
weights, so ``code_weights`` apply only with ``use_code_weights=True``.
"""
from __future__ import annotations

import math
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


def weighted_softmax_cross_entropy(logits: torch.Tensor, one_hot_targets: torch.Tensor,
                                   weights: torch.Tensor, logit_scale: float = 1.0) -> torch.Tensor:
    """Weighted softmax cross-entropy [B, A]: logits / one-hot targets
    [B, A, C], weights [B, A]."""
    logp = torch.log_softmax(logits / logit_scale, dim=-1)
    return -(one_hot_targets * logp).sum(-1) * weights


def balanced_l1_loss(preds: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor,
                     alpha: float = 0.5, gamma: float = 1.5, beta: float = 1.0) -> torch.Tensor:
    """Balanced L1 (Libra R-CNN), per element [B, A, code]; weights [B, A]."""
    diff = torch.abs(preds - targets)
    b = math.e ** (gamma / alpha) - 1
    loss = torch.where(
        diff < beta,
        alpha / b * (b * diff + 1) * torch.log(b * diff / beta + 1) - alpha * diff,
        gamma * diff + gamma / b - alpha * beta)
    return loss * weights[..., None]


def ghm_classification_loss(logits: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor,
                            bins: int = 10, momentum: float = 0.0) -> torch.Tensor:
    """Gradient-harmonised classification loss [B, A, C]: the per-element
    sigmoid cross-entropy reweighted by tot / (elements in its gradient-norm
    bin), over the elements of anchors with a positive weight. The last bin
    is widened by 1e-6 to hold g = 1. ``momentum`` is accepted and unused,
    as in JAX."""
    g = torch.abs(torch.sigmoid(logits) - targets)
    valid = (weights > 0)[..., None] & torch.ones_like(targets, dtype=torch.bool)
    tot = torch.clamp(valid.sum(), min=1)
    w = torch.zeros_like(g)
    for i in range(bins):
        lo, hi = i / bins, (i + 1) / bins + (1e-6 if i == bins - 1 else 0.0)
        in_bin = (g >= lo) & (g < hi) & valid
        num_in_bin = in_bin.sum()
        density = torch.where(num_in_bin > 0, tot / torch.clamp(num_in_bin, min=1),
                              torch.zeros((), dtype=g.dtype, device=g.device))
        w = torch.where(in_bin, density.to(g.dtype), w)
    return sigmoid_cross_entropy_with_logits(logits, targets) * w / tot


def iou_regression_loss(pred_iou: torch.Tensor, target_iou: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """Smooth-L1 (sigma 3) on predicted IoUs [B, A]; weights [B, A]."""
    return weighted_smooth_l1(pred_iou[..., None], target_iou[..., None], weights,
                              sigma=3.0)[..., 0]
