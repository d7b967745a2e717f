"""Fixed-shape greedy NMS (port of ``dal3d_tpu/ops/nms.py``:
``greedy_nms_from_iou`` over a precomputed IoU matrix, and ``rotate_nms``
around it), and the top k in ``jax.lax.top_k``'s order that picks the
candidates."""
from __future__ import annotations

import torch

from . import iou_matrix


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


def rotate_nms(boxes_bev: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
               pre_max_size: int = 1000, post_max_size: int = 83,
               iou_threshold: float = 0.2):
    """Rotated NMS with a fixed output size: boxes_bev [N, 5] (x, y, w, l,
    yaw), scores [N], valid [N] bool -> (indices [post_max_size] into the
    inputs, kept [post_max_size] bool), the kept boxes in descending score
    order.

    The IoU matrix of the ``pre_max_size`` best valid boxes comes from
    ``iou_matrix.rotated_iou_matrix_batched``, which launches K2 on a CUDA
    tensor and runs its plain twin on a CPU one, as the detection head does
    (JAX's ``rotate_nms`` takes ``rotated_iou_fast.rotated_iou_matrix_greens``)."""
    masked = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    top_scores, top_idx = top_k(masked, pre_max_size)
    one = boxes_bev[top_idx][None].contiguous()  # one record set, the kernel's mirrored route
    iou = iou_matrix.rotated_iou_matrix_batched(one, one)[0]
    keep = greedy_nms_from_iou(iou, torch.isfinite(top_scores), iou_threshold)
    sel_scores, sel = top_k(torch.where(keep, top_scores, torch.full_like(top_scores,
                                                                          float("-inf"))),
                            post_max_size)
    return top_idx[sel], torch.isfinite(sel_scores)
