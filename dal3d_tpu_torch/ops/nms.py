"""Fixed-shape greedy NMS from a precomputed IoU matrix (port of
``dal3d_tpu/ops/nms.py::greedy_nms_from_iou``)."""
from __future__ import annotations

import torch


def greedy_nms_from_iou(iou: torch.Tensor, valid: torch.Tensor,
                        iou_threshold: float) -> torch.Tensor:
    """Greedy NMS over boxes already sorted by descending score.

    iou [..., N, N], valid [..., N] (invalid boxes are never kept); leading
    dims are independent sets. Returns keep [..., N] bool.

    Iterates the suppression map
        keep[i] <- valid[i] and no j < i with keep[j] and iou[j, i] > t
    to its fixpoint, the same loop as the JAX version: the greedy solution is
    the unique fixpoint, reached after the depth of the longest suppression
    chain (bounded by N). Each iteration reads one flag back to the host.
    """
    N = iou.shape[-1]
    upper = torch.ones(N, N, dtype=torch.bool, device=iou.device).triu(1)
    suppress = (iou > iou_threshold) & upper  # [j, i]: j suppresses i
    keep, prev = valid, ~valid
    it = 0
    while it < N and bool((keep != prev).any()):
        suppressed = (suppress & keep[..., :, None]).any(dim=-2)
        keep, prev = valid & ~suppressed, keep
        it += 1
    return keep
