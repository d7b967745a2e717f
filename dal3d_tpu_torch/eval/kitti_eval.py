"""KITTI-style AP evaluation, BEV and 3D (port of
``dal3d_tpu/eval/kitti_eval.py``).

AP-40 over score thresholds with rotated-BEV / 3D IoU matching (greedy by
confidence per frame), per-class IoU thresholds (Car 0.7, others 0.5), and
the official easy / moderate / hard difficulty bins (a GT above the bin's
difficulty is *ignored*: predictions matched to it count neither as TP nor
FP). Works on lidar-frame [N, 9] boxes; gt frames may carry either a
precomputed ``difficulty`` [N] (0/1/2, -1 = beyond hard) or the raw ``bbox``
[N, 4] / ``occluded`` [N] / ``truncated`` [N] annotations it derives from.
Without difficulty info a single 'overall' bin is reported.

The IoU matrices come from ``ops/rotated_iou.py`` on ``device`` (``None``
means the CUDA card, as every entry point of the port); the matching and the
AP sweep are host numpy, in the JAX module's order (``np.argsort(-scores)``
keeps its tie order).
"""
from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional

import numpy as np

import torch

from ..device import resolve_device
from ..ops import rotated_iou

IOU_THRESH = {"Car": 0.7, "car": 0.7}
DEFAULT_IOU = 0.5

# official bins (kitti_object_eval_python/eval.py: MIN_HEIGHT/MAX_OCCLUSION/
# MAX_TRUNCATION per difficulty)
MIN_HEIGHT = (40.0, 25.0, 25.0)
MAX_OCCLUSION = (0, 1, 2)
MAX_TRUNCATION = (0.15, 0.30, 0.50)
DIFFICULTY_NAMES = ("easy", "moderate", "hard")


def compute_difficulty(bbox: np.ndarray, occluded: np.ndarray,
                       truncated: np.ndarray) -> np.ndarray:
    """Per-GT difficulty 0/1/2 (-1 = fails even 'hard') from the image bbox
    height + occlusion state + truncation (reference add_difficulty_to_annos)."""
    h = np.asarray(bbox)[:, 3] - np.asarray(bbox)[:, 1]
    occ = np.asarray(occluded)
    tr = np.asarray(truncated)
    diff = np.full(len(h), -1, np.int32)
    for d in (2, 1, 0):  # hard -> easy so the easiest passing bin wins
        ok = (h >= MIN_HEIGHT[d]) & (occ <= MAX_OCCLUSION[d]) & (tr <= MAX_TRUNCATION[d])
        diff = np.where(ok, d, diff)
    return diff


def _gt_difficulty(gt: dict) -> Optional[np.ndarray]:
    if "difficulty" in gt:
        return np.asarray(gt["difficulty"], np.int32)
    if all(k in gt for k in ("bbox", "occluded", "truncated")):
        return compute_difficulty(gt["bbox"], gt["occluded"], gt["truncated"])
    return None


def _iou_on(fn, boxes1: np.ndarray, boxes2: np.ndarray, device) -> np.ndarray:
    """``fn`` of two f32 box sets on ``device``, back on the host (JAX's
    ``jnp.asarray`` makes the same f32 arrays)."""
    b1 = torch.as_tensor(np.asarray(boxes1, np.float32), device=device)
    b2 = torch.as_tensor(np.asarray(boxes2, np.float32), device=device)
    return fn(b1, b2).cpu().numpy()


def _bev_iou(boxes1: np.ndarray, boxes2: np.ndarray, device) -> np.ndarray:
    """Rotated BEV IoU through the polygon clipper (exact)."""
    if len(boxes1) == 0 or len(boxes2) == 0:
        return np.zeros((len(boxes1), len(boxes2)))
    b1 = np.asarray(boxes1)[:, [0, 1, 3, 4, 8]]
    b2 = np.asarray(boxes2)[:, [0, 1, 3, 4, 8]]
    return _iou_on(rotated_iou.rotated_iou_matrix, b1, b2, device)


def _3d_iou(boxes1: np.ndarray, boxes2: np.ndarray, device) -> np.ndarray:
    if len(boxes1) == 0 or len(boxes2) == 0:
        return np.zeros((len(boxes1), len(boxes2)))
    return _iou_on(rotated_iou.boxes_iou3d, boxes1, boxes2, device)


def _ap40(matched_flags: np.ndarray, scores: np.ndarray, n_gt: int) -> float:
    """AP with 40 recall positions (KITTI 2019 metric)."""
    if n_gt == 0 or len(scores) == 0:
        return 0.0
    order = np.argsort(-scores)
    tp = matched_flags[order].astype(np.float64)
    fp = 1.0 - tp
    tp_cum, fp_cum = np.cumsum(tp), np.cumsum(fp)
    recall = tp_cum / n_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    ap = 0.0
    for r in np.linspace(0.025, 1.0, 40):
        mask = recall >= r
        ap += (precision[mask].max() if mask.any() else 0.0) / 40
    return float(ap)


def _eval_bin(gt_frames, pred_frames, cls, thr, iou_fn, max_difficulty):
    """AP-40 for one (class, metric, difficulty) cell. GTs harder than the
    bin are ignored: a prediction matched to one is dropped entirely."""
    all_scores, all_matched = [], []
    n_gt = 0
    for gt, pred in zip(gt_frames, pred_frames):
        gmask = np.asarray(gt["names"]) == cls
        pmask = np.asarray(pred["names"]) == cls
        gboxes = np.asarray(gt["boxes"])[gmask]
        pboxes = np.asarray(pred["boxes"])[pmask]
        pscores = np.asarray(pred["scores"])[pmask]
        diff = _gt_difficulty(gt)
        if max_difficulty is None or diff is None:
            care = np.ones(len(gboxes), bool)
        else:
            d = diff[gmask]
            care = (d >= 0) & (d <= max_difficulty)
        n_gt += int(care.sum())
        if len(pboxes) == 0:
            continue
        iou = iou_fn(pboxes, gboxes)
        matched = np.zeros(len(pboxes), bool)
        keep = np.ones(len(pboxes), bool)  # False = matched an ignored GT
        taken = np.zeros(len(gboxes), bool)
        for pi in np.argsort(-pscores):
            if len(gboxes) == 0:
                break
            row = np.where(taken, -1.0, iou[pi])
            gi = int(np.argmax(row))
            if not taken[gi] and iou[pi, gi] >= thr:
                taken[gi] = True
                if care[gi]:
                    matched[pi] = True
                else:
                    keep[pi] = False  # ignored GT: neither TP nor FP
        all_scores.append(pscores[keep])
        all_matched.append(matched[keep])
    scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
    matched = np.concatenate(all_matched) if all_matched else np.zeros(0, bool)
    return _ap40(matched, scores, n_gt)


def kitti_eval(gt_frames: List[dict], pred_frames: List[dict], class_names: List[str],
               device=None) -> Dict:
    """gt/pred_frames: per frame {boxes [N,9], names [N], (scores)}; gt may
    carry difficulty annotations (see module docstring) to get the official
    easy/moderate/hard bins. The IoUs run on ``device`` (``None``: the CUDA
    card; raises without one)."""
    dev = resolve_device(device)
    has_difficulty = any(_gt_difficulty(gt) is not None for gt in gt_frames)
    bins = list(enumerate(DIFFICULTY_NAMES)) if has_difficulty else [(None, "overall")]
    results = {}
    for cls in class_names:
        thr = IOU_THRESH.get(cls, DEFAULT_IOU)
        for metric, iou_fn in (("bev", partial(_bev_iou, device=dev)),
                               ("3d", partial(_3d_iou, device=dev))):
            for max_d, bin_name in bins:
                ap = _eval_bin(gt_frames, pred_frames, cls, thr, iou_fn, max_d)
                key = (f"{cls}_{metric}_AP40" if bin_name == "overall"
                       else f"{cls}_{metric}_{bin_name}_AP40")
                results[key] = ap
    for metric in ("bev", "3d"):
        for _, bin_name in bins:
            sfx = f"{metric}_AP40" if bin_name == "overall" else f"{metric}_{bin_name}_AP40"
            vals = [v for k, v in results.items() if k.endswith(sfx)]
            key = f"mAP_{metric}" if bin_name == "overall" else f"mAP_{metric}_{bin_name}"
            results[key] = float(np.mean(vals))
    if has_difficulty:  # headline = moderate (KITTI leaderboard convention)
        results["mAP_bev"] = results["mAP_bev_moderate"]
        results["mAP_3d"] = results["mAP_3d_moderate"]
    return {"results": results}
