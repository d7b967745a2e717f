"""Lyft Level-5 evaluation score, the kaggle 3D-detection metric (port of
``dal3d_tpu/eval/lyft_eval.py``).

The reference's semantics (det3d/datasets/lyft/eval.py:43-95
``get_lyft_eval_result``): for each of 10 IoU thresholds (0.5 : 0.05 :
0.95), detections are matched greedily by confidence to same-class GTs by
3D IoU in the lidar frame, and the score is

    S = mean over thresholds and frames of  TP / (TP + FP + FN)

with TP / FP / FN summed over classes within a frame. Boxes are lidar-frame
[N, >=7] (x, y, z, w, l, h, ..., yaw) with z the bottom centre. The IoUs
come from ``ops/rotated_iou.py::boxes_iou3d`` on ``device`` (``None``: the
CUDA card, as every entry point of the port), in f32 as JAX's ``jnp``
arrays; the matching is host numpy in the JAX module's order.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..device import resolve_device
from ..ops.rotated_iou import boxes_iou3d


def _iou3d(pred: np.ndarray, gt: np.ndarray, device) -> np.ndarray:
    if len(pred) == 0 or len(gt) == 0:
        return np.zeros((len(pred), len(gt)))
    p = torch.as_tensor(np.asarray(pred, np.float32), device=device)
    g = torch.as_tensor(np.asarray(gt, np.float32), device=device)
    return boxes_iou3d(p, g).cpu().numpy()


def _rows(boxes, n: int) -> np.ndarray:
    """Boxes as [n, D] float64; a frame without boxes gives [0, 9] (JAX's
    ``reshape(0, -1)`` raises there, so its evaluation stops at the first
    frame without a detection or a GT box: ROADMAP C.4)."""
    return np.asarray(boxes, np.float64).reshape(n, -1) if n else np.zeros((0, 9))


def _match_counts(iou: np.ndarray, scores: np.ndarray, thr: float):
    """Confidence-greedy matching (one GT per det). Returns (tp, fp, fn)."""
    n_pred, n_gt = iou.shape
    taken = np.zeros(n_gt, bool)
    tp = 0
    for pi in np.argsort(-scores):
        row = np.where(taken, -1.0, iou[pi])
        if n_gt and row.max() >= thr:
            taken[int(np.argmax(row))] = True
            tp += 1
    return tp, n_pred - tp, n_gt - tp


def lyft_eval(gt_frames: List[dict], pred_frames: List[dict], class_names: List[str],
              device=None) -> Dict:
    """gt / pred_frames: per frame {boxes [N, >=7], names [N], (scores [N])}.
    The IoUs run on ``device`` (``None``: the CUDA card; raises without
    one)."""
    dev = resolve_device(device)
    thresholds = np.arange(0.5, 1.0, 0.05)
    per_thr = np.zeros((len(thresholds), len(gt_frames)))
    for fi, (gt, pred) in enumerate(zip(gt_frames, pred_frames)):
        gnames = np.asarray(gt["names"])
        pnames = np.asarray(pred["names"])
        gboxes, pboxes = _rows(gt["boxes"], len(gnames)), _rows(pred["boxes"], len(pnames))
        pscores = np.asarray(pred.get("scores", np.ones(len(pnames))))
        counts = np.zeros((len(thresholds), 3))
        for cls in class_names:
            gm, pm = gnames == cls, pnames == cls
            iou = _iou3d(pboxes[pm], gboxes[gm], dev)
            for k, thr in enumerate(thresholds):
                counts[k] += _match_counts(iou, pscores[pm], thr)
        tp, fp, fn = counts[:, 0], counts[:, 1], counts[:, 2]
        denom = tp + fp + fn
        per_thr[:, fi] = np.where(denom > 0, tp / np.maximum(denom, 1), 0.0)
    score = float(per_thr.mean()) if per_thr.size else 0.0
    return {
        "lyft_score": score,
        "per_threshold": {f"{t:.2f}": float(per_thr[k].mean())
                          for k, t in enumerate(thresholds)},
    }
