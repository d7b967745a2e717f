"""Fixed-shape greedy NMS from a precomputed IoU matrix (port of
``dal3d_tpu/ops/nms.py::greedy_nms_from_iou``), and the top k in
``jax.lax.top_k``'s order that picks the candidates around it."""
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


def top_k(x: torch.Tensor, k: int):
    """Top k along the last dim with ``jax.lax.top_k``'s order: descending
    values, the lower index first among equal ones (a stable sort;
    ``torch.topk`` promises no order among ties, and the CPU and the card
    break them differently)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
