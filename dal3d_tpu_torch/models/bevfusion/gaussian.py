"""CenterNet-style gaussian heatmap targets and the gaussian focal loss (port
of ``dal3d_tpu/models/bevfusion/gaussian.py``).

The reference draws each box's gaussian into a patch of its own size; here,
as in JAX, every GT box writes a fixed (2 * rmax + 1)^2 window with a
radius mask, composited by a scatter-max (``scatter_reduce_`` "amax", so a
repeat gives the same bits): equal values wherever the radius is <= rmax.
"""
from __future__ import annotations

import torch


def gaussian_radius(length: torch.Tensor, width: torch.Tensor,
                    min_overlap: float) -> torch.Tensor:
    """CornerNet radius of boxes (length, width) in feature cells. The third
    root is divided by 2 and not by 2a, the reference's quirk, kept for
    target parity."""
    h, w = length, width
    b1 = h + w
    c1 = w * h * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 ** 2 - 4 * c1, min=0.0))) / 2
    b2 = 2 * (h + w)
    c2 = (1 - min_overlap) * w * h
    r2 = (b2 + torch.sqrt(torch.clamp(b2 ** 2 - 16 * c2, min=0.0))) / 2
    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (h + w)
    c3 = (min_overlap - 1) * w * h
    r3 = (b3 + torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def draw_gaussian_heatmap(centers_xy: torch.Tensor, radii: torch.Tensor, classes: torch.Tensor,
                          valid: torch.Tensor, H: int, W: int, nc: int,
                          rmax: int = 12) -> torch.Tensor:
    """[B, H, W, nc] max-composited gaussian targets: centers_xy [B, G, 2]
    float feature-cell coordinates (floored to the cell), radii [B, G] int,
    classes [B, G] 0-based, valid [B, G]. A window value is exp(-(dx^2 +
    dy^2) / (2 sigma^2)) with sigma = (2r + 1) / 6, inside the radius box."""
    B, G = radii.shape
    dev = centers_xy.device
    cx = torch.floor(centers_xy[..., 0]).long()
    cy = torch.floor(centers_xy[..., 1]).long()
    dyx = torch.arange(-rmax, rmax + 1, device=dev)
    dy, dx = dyx[:, None], dyx[None, :]
    sigma = (2 * radii.float() + 1) / 6.0
    d2 = (dx ** 2 + dy ** 2).float()
    val = torch.exp(-d2[None, None] / (2 * sigma[..., None, None] ** 2))  # [B, G, win, win]
    r = radii[..., None, None]
    inside = (dx.abs() <= r) & (dy.abs() <= r)
    keep = valid[..., None, None]
    val = torch.where(inside & keep, val, torch.zeros((), device=dev))
    py = cy[..., None, None] + dy
    px = cx[..., None, None] + dx
    inb = (py >= 0) & (py < H) & (px >= 0) & (px < W)
    lin = torch.where(inb & keep, (py * W + px) * nc + classes.long()[..., None, None],
                      H * W * nc).reshape(B, -1)
    out = torch.zeros(B, H * W * nc + 1, dtype=val.dtype, device=dev)
    out.scatter_reduce_(1, lin, val.reshape(B, -1), "amax")
    return out[:, :-1].reshape(B, H, W, nc)


def gaussian_focal_loss(pred_logits: torch.Tensor, target: torch.Tensor, alpha: float = 2.0,
                        gamma: float = 4.0, eps: float = 1e-12) -> torch.Tensor:
    """Penalty-reduced pixelwise focal loss (mmdet GaussianFocalLoss),
    elementwise: -(1 - p)^alpha log(p) where the target is 1, -(1 - t)^gamma
    p^alpha log(1 - p) elsewhere (the caller normalises)."""
    p = torch.sigmoid(pred_logits)
    pos_w = (target == 1.0).to(p.dtype)
    neg_w = torch.pow(1 - target, gamma)
    pos_loss = -torch.log(p + eps) * torch.pow(1 - p, alpha) * pos_w
    neg_loss = -torch.log(1 - p + eps) * torch.pow(p, alpha) * neg_w * (1 - pos_w)
    return pos_loss + neg_loss
