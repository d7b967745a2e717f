"""Official KITTI object-detection evaluation (port of
``dal3d_tpu/eval/kitti_official.py``: pure numpy, copied, so that every
decision and metric is JAX's).

The semantics of the reference harness
det3d/datasets/utils/kitti_object_eval_python/eval.py (the numba port of the
official C++ devkit):

- annos in CAMERA coordinates, one dict per frame with the KITTI label
  fields: name, truncated, occluded, alpha, bbox [N,4], dimensions [N,3]
  (l,h,w), location [N,3] (x,y,z), rotation_y, (dt only) score.
- clean_data (eval.py:29): per (class, difficulty) GT partition into
  counted (0) / ignored (1: similar class Van->Car, Person_sitting->
  Pedestrian, or harder-than-bin) / irrelevant (-1); detections shorter
  than MIN_HEIGHT[difficulty] in image space are ignored.
- compute_statistics (eval.py:164): confidence-greedy GT-driven matching
  with the official tie-breaking (best score in the no-fp pass; best
  overlap in the fp pass), DontCare-region FP removal for the bbox metric,
  and AOS orientation similarity (1+cos(alpha_gt-alpha_dt))/2.
- 41 recall-sampled score thresholds (get_thresholds, eval.py:8),
  precision envelope, mAP_R11 = mean of precision[0::4] (eval.py:601) and
  mAP_R40 = mean of precision[1:41] (the 2019 metric).
- metrics: 0 = 2D bbox, 1 = BEV (x-z plane), 2 = 3D; official per-class
  min-overlap tables (eval.py:655-668).

The matching loops are restructured (per-frame vectorized IoU, one match
routine for both passes) but decision-for-decision equivalent to the
numba kernels.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

CLASS_TO_NAME = {0: "Car", 1: "Pedestrian", 2: "Cyclist", 3: "Van", 4: "Person_sitting"}
NAME_TO_CLASS = {v: k for k, v in CLASS_TO_NAME.items()}
MIN_HEIGHT = (40.0, 25.0, 25.0)
MAX_OCCLUSION = (0, 1, 2)
MAX_TRUNCATION = (0.15, 0.30, 0.50)
N_SAMPLE_PTS = 41

# [num_overlap=2, metric(bbox,bev,3d), class(Car,Ped,Cyc,Van,Person_sitting)]
OVERLAP_MODERATE = np.array(
    [[0.7, 0.5, 0.5, 0.7, 0.5]] * 3
)
OVERLAP_EASY = np.array(
    [[0.7, 0.5, 0.5, 0.7, 0.5],
     [0.5, 0.25, 0.25, 0.5, 0.25],
     [0.5, 0.25, 0.25, 0.5, 0.25]]
)
MIN_OVERLAPS = np.stack([OVERLAP_MODERATE, OVERLAP_EASY], axis=0)  # [2, 3, 5]


# ---------------------------------------------------------------------------
# overlaps
# ---------------------------------------------------------------------------
def image_box_overlap(boxes: np.ndarray, qboxes: np.ndarray, criterion: int = -1):
    """Axis-aligned 2D IoU (criterion -1) or intersection/box-area (0)."""
    if len(boxes) == 0 or len(qboxes) == 0:
        return np.zeros((len(boxes), len(qboxes)))
    b = boxes[:, None]
    q = qboxes[None, :]
    iw = np.minimum(b[..., 2], q[..., 2]) - np.maximum(b[..., 0], q[..., 0])
    ih = np.minimum(b[..., 3], q[..., 3]) - np.maximum(b[..., 1], q[..., 1])
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    inter = np.where((iw > 0) & (ih > 0), inter, 0.0)
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    area_q = (q[..., 2] - q[..., 0]) * (q[..., 3] - q[..., 1])
    if criterion == -1:
        ua = area_b + area_q - inter
    elif criterion == 0:
        ua = area_b + np.zeros_like(inter)
    else:
        ua = area_q + np.zeros_like(inter)
    return np.where(ua > 0, inter / ua, 0.0)


def _rotated_rect_corners(boxes: np.ndarray) -> np.ndarray:
    """[N, 5] (cx, cy, w, l, angle) -> [N, 4, 2] corners."""
    cx, cy, w, l, a = boxes.T
    # counter-clockwise (the Sutherland-Hodgman inside-test requires it)
    dx = np.stack([l / 2, -l / 2, -l / 2, l / 2], -1)
    dy = np.stack([w / 2, w / 2, -w / 2, -w / 2], -1)
    cos, sin = np.cos(a)[:, None], np.sin(a)[:, None]
    x = cx[:, None] + dx * cos - dy * sin
    y = cy[:, None] + dx * sin + dy * cos
    return np.stack([x, y], -1)


def _poly_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _clip_poly(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman convex clip."""
    out = list(subject)
    n = len(clip)
    for i in range(n):
        a, b = clip[i], clip[(i + 1) % n]
        edge = b - a
        inp, out = out, []
        if not inp:
            break
        for j, p in enumerate(inp):
            q = inp[(j + 1) % len(inp)]
            pin = edge[0] * (p[1] - a[1]) - edge[1] * (p[0] - a[0]) >= 0
            qin = edge[0] * (q[1] - a[1]) - edge[1] * (q[0] - a[0]) >= 0
            if pin:
                out.append(p)
            if pin != qin:
                denom = edge[0] * (q[1] - p[1]) - edge[1] * (q[0] - p[0])
                if abs(denom) > 1e-12:
                    t = (edge[0] * (a[1] - p[1]) - edge[1] * (a[0] - p[0])) / denom
                    out.append(p + t * (q - p))
    return np.asarray(out) if out else np.zeros((0, 2))


def rotated_box_intersection(c1: np.ndarray, c2: np.ndarray) -> float:
    inter = _clip_poly(c1, c2)
    return _poly_area(inter) if len(inter) >= 3 else 0.0


def bev_box_overlap(boxes: np.ndarray, qboxes: np.ndarray, criterion: int = -1):
    """Rotated IoU over [N,5] (x, z, l, w, ry) camera-BEV boxes."""
    if len(boxes) == 0 or len(qboxes) == 0:
        return np.zeros((len(boxes), len(qboxes)))
    b5 = boxes[:, [0, 1, 3, 2, 4]]  # (cx, cy, w, l, a)
    q5 = qboxes[:, [0, 1, 3, 2, 4]]
    cb = _rotated_rect_corners(b5)
    cq = _rotated_rect_corners(q5)
    out = np.zeros((len(boxes), len(qboxes)))
    area_b = boxes[:, 2] * boxes[:, 3]
    area_q = qboxes[:, 2] * qboxes[:, 3]
    for i in range(len(boxes)):
        for j in range(len(qboxes)):
            inter = rotated_box_intersection(cb[i], cq[j])
            if criterion == -1:
                ua = area_b[i] + area_q[j] - inter
            elif criterion == 0:
                ua = area_b[i]
            elif criterion == 1:
                ua = area_q[j]
            else:  # criterion 2: raw intersection area (for d3_box_overlap)
                out[i, j] = inter
                continue
            out[i, j] = inter / ua if ua > 0 else 0.0
    return out


def d3_box_overlap(boxes: np.ndarray, qboxes: np.ndarray):
    """3D IoU in camera coords: boxes [N, 7] (x, y, z, l, h, w, ry); y is the
    box BOTTOM (KITTI camera frame, y points down)."""
    if len(boxes) == 0 or len(qboxes) == 0:
        return np.zeros((len(boxes), len(qboxes)))
    bev_b = boxes[:, [0, 2, 3, 5, 6]]  # x, z, l, w, ry
    bev_q = qboxes[:, [0, 2, 3, 5, 6]]
    rinc = bev_box_overlap(bev_b, bev_q, criterion=2)  # raw intersection area
    inter_area = rinc * 1.0
    out = np.zeros_like(rinc)
    for i in range(len(boxes)):
        for j in range(len(qboxes)):
            if inter_area[i, j] <= 0:
                continue
            iw = min(boxes[i, 1], qboxes[j, 1]) - max(
                boxes[i, 1] - boxes[i, 4], qboxes[j, 1] - qboxes[j, 4]
            )
            if iw <= 0:
                continue
            vol_inter = iw * inter_area[i, j]
            vol1 = boxes[i, 3] * boxes[i, 4] * boxes[i, 5]
            vol2 = qboxes[j, 3] * qboxes[j, 4] * qboxes[j, 5]
            ua = vol1 + vol2 - vol_inter
            out[i, j] = vol_inter / ua if ua > 0 else 0.0
    return out


# ---------------------------------------------------------------------------
# per-frame partition + matching
# ---------------------------------------------------------------------------
def clean_data(gt: dict, dt: dict, current_class: int, difficulty: int):
    """Official GT/DT partition (reference eval.py:29-88)."""
    cls_name = CLASS_TO_NAME[current_class].lower()
    ignored_gt, ignored_dt, dc_bboxes = [], [], []
    num_valid_gt = 0
    for i in range(len(gt["name"])):
        name = str(gt["name"][i]).lower()
        height = gt["bbox"][i, 3] - gt["bbox"][i, 1]
        if name == cls_name:
            valid = 1
        elif cls_name == "pedestrian" and name == "person_sitting":
            valid = 0
        elif cls_name == "car" and name == "van":
            valid = 0
        else:
            valid = -1
        ignore = (
            gt["occluded"][i] > MAX_OCCLUSION[difficulty]
            or gt["truncated"][i] > MAX_TRUNCATION[difficulty]
            or height <= MIN_HEIGHT[difficulty]
        )
        if valid == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid == 0 or (ignore and valid == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if str(gt["name"][i]) == "DontCare":
            dc_bboxes.append(gt["bbox"][i])
    for i in range(len(dt["name"])):
        height = abs(dt["bbox"][i, 3] - dt["bbox"][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif str(dt["name"][i]).lower() == cls_name:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    dc = np.stack(dc_bboxes, 0) if dc_bboxes else np.zeros((0, 4))
    return num_valid_gt, np.array(ignored_gt), np.array(ignored_dt), dc


def compute_statistics(overlaps, gt_alphas, dt_alphas, dt_bboxes, dt_scores,
                       ignored_gt, ignored_det, dc_bboxes, metric, min_overlap,
                       thresh=0.0, compute_fp=False, compute_aos=False):
    """One frame's (tp, fp, fn, aos-similarity, matched-scores).

    overlaps [num_dt, num_gt]. Decision-equivalent to the reference
    compute_statistics_jit (eval.py:164-280)."""
    det_size, gt_size = len(dt_scores), len(ignored_gt)
    assigned = np.zeros(det_size, bool)
    ignored_threshold = (dt_scores < thresh) if compute_fp else np.zeros(det_size, bool)
    NO_DET = -10000000.0
    tp = fp = fn = 0
    similarity = 0.0
    thresholds: List[float] = []
    delta: List[float] = []
    for i in range(gt_size):
        if ignored_gt[i] == -1:
            continue
        det_idx = -1
        valid_detection = NO_DET
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(det_size):
            if ignored_det[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            if not compute_fp:
                if overlap > min_overlap and dt_scores[j] > valid_detection:
                    det_idx, valid_detection = j, dt_scores[j]
            else:
                if (overlap > min_overlap
                        and (overlap > max_overlap or assigned_ignored_det)
                        and ignored_det[j] == 0):
                    max_overlap, det_idx, valid_detection = overlap, j, 1.0
                    assigned_ignored_det = False
                elif (overlap > min_overlap and valid_detection == NO_DET
                      and ignored_det[j] == 1):
                    det_idx, valid_detection = j, 1.0
                    assigned_ignored_det = True
        if valid_detection == NO_DET and ignored_gt[i] == 0:
            fn += 1
        elif valid_detection != NO_DET and (
            ignored_gt[i] == 1 or ignored_det[det_idx] == 1
        ):
            assigned[det_idx] = True
        elif valid_detection != NO_DET:
            tp += 1
            thresholds.append(dt_scores[det_idx])
            if compute_aos:
                delta.append(gt_alphas[i] - dt_alphas[det_idx])
            assigned[det_idx] = True
    if compute_fp:
        fp = int(np.sum(~assigned & (ignored_det == 0) & ~ignored_threshold))
        if metric == 0 and len(dc_bboxes) > 0:
            ov_dc = image_box_overlap(dt_bboxes, dc_bboxes, criterion=0)
            nstuff = 0
            for i in range(len(dc_bboxes)):
                for j in range(det_size):
                    if (assigned[j] or ignored_det[j] in (-1, 1)
                            or ignored_threshold[j]):
                        continue
                    if ov_dc[j, i] > min_overlap:
                        assigned[j] = True
                        nstuff += 1
            fp -= nstuff
        if compute_aos:
            sims = [(1.0 + np.cos(d)) / 2.0 for d in delta]
            similarity = float(np.sum(sims)) if (tp > 0 or fp > 0) else -1.0
    return tp, fp, fn, similarity, np.array(thresholds)


def get_thresholds(scores: np.ndarray, num_gt: int, num_sample_pts: int = N_SAMPLE_PTS):
    """Recall-sampled score thresholds (reference eval.py:8-27)."""
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return np.array(thresholds)


# ---------------------------------------------------------------------------
# evaluation over frames
# ---------------------------------------------------------------------------
def _frame_overlaps(gt: dict, dt: dict, metric: int) -> np.ndarray:
    if metric == 0:
        return image_box_overlap(dt["bbox"], gt["bbox"])
    if metric == 1:
        def bev(a):
            return np.concatenate(
                [a["location"][:, [0, 2]], a["dimensions"][:, [0, 2]],
                 a["rotation_y"][:, None]], axis=1
            )
        return bev_box_overlap(bev(dt), bev(gt))
    def full(a):
        return np.concatenate(
            [a["location"], a["dimensions"], a["rotation_y"][:, None]], axis=1
        )
    return d3_box_overlap(full(dt), full(gt))


def eval_class(gt_annos: List[dict], dt_annos: List[dict], current_class: int,
               difficulty: int, metric: int, min_overlap: float,
               compute_aos: bool = False) -> Dict[str, np.ndarray]:
    """Precision/recall/AOS curves at 41 recall samples for one cell."""
    assert len(gt_annos) == len(dt_annos)
    frames = []
    total_num_valid_gt = 0
    for gt, dt in zip(gt_annos, dt_annos):
        num_valid_gt, ig_gt, ig_dt, dc = clean_data(gt, dt, current_class, difficulty)
        total_num_valid_gt += num_valid_gt
        frames.append({
            "overlaps": _frame_overlaps(gt, dt, metric),
            "gt_alphas": np.asarray(gt["alpha"], np.float64),
            "dt_alphas": np.asarray(dt["alpha"], np.float64),
            "dt_bboxes": np.asarray(dt["bbox"], np.float64).reshape(-1, 4),
            "dt_scores": np.asarray(dt["score"], np.float64),
            "ignored_gt": ig_gt, "ignored_det": ig_dt, "dc_bboxes": dc,
        })

    all_thresholds = []
    for f in frames:
        _, _, _, _, th = compute_statistics(
            f["overlaps"], f["gt_alphas"], f["dt_alphas"], f["dt_bboxes"],
            f["dt_scores"], f["ignored_gt"], f["ignored_det"], f["dc_bboxes"],
            metric, min_overlap, thresh=0.0, compute_fp=False,
        )
        all_thresholds += th.tolist()
    if total_num_valid_gt == 0:
        z = np.zeros(N_SAMPLE_PTS)
        return {"precision": z, "recall": z, "orientation": z}
    thresholds = get_thresholds(np.array(all_thresholds), total_num_valid_gt)

    pr = np.zeros((len(thresholds), 4))
    for f in frames:
        for t, thresh in enumerate(thresholds):
            tp, fp, fn, sim, _ = compute_statistics(
                f["overlaps"], f["gt_alphas"], f["dt_alphas"], f["dt_bboxes"],
                f["dt_scores"], f["ignored_gt"], f["ignored_det"], f["dc_bboxes"],
                metric, min_overlap, thresh=thresh, compute_fp=True,
                compute_aos=compute_aos,
            )
            pr[t, 0] += tp
            pr[t, 1] += fp
            pr[t, 2] += fn
            if sim != -1:
                pr[t, 3] += sim

    precision = np.zeros(N_SAMPLE_PTS)
    recall = np.zeros(N_SAMPLE_PTS)
    aos = np.zeros(N_SAMPLE_PTS)
    nt = len(thresholds)
    precision[:nt] = pr[:, 0] / np.maximum(pr[:, 0] + pr[:, 1], 1e-9)
    recall[:nt] = pr[:, 0] / np.maximum(pr[:, 0] + pr[:, 2], 1e-9)
    if compute_aos:
        aos[:nt] = pr[:, 3] / np.maximum(pr[:, 0] + pr[:, 1], 1e-9)
    # precision envelope (running max from the right)
    for i in range(N_SAMPLE_PTS):
        precision[i] = precision[i:].max()
        if compute_aos:
            aos[i] = aos[i:].max()
    return {"precision": precision, "recall": recall, "orientation": aos}


def map_r11(prec: np.ndarray) -> float:
    """11-point AP: precision at recall 0, 0.1, ..., 1.0 (eval.py:601-605)."""
    return float(prec[0::4].sum() / 11 * 100)


def map_r40(prec: np.ndarray) -> float:
    """40-point AP: precision at recall 1/40 ... 1.0 (2019 metric)."""
    return float(prec[1:].sum() / 40 * 100)


def get_official_eval_result(gt_annos: List[dict], dt_annos: List[dict],
                             current_classes: Sequence) -> Dict[str, float]:
    """Full official table: AP_R11 + AP_R40 for bbox/bev/3d (+AOS when dt
    alphas are provided) x easy/moderate/hard x both overlap rows."""
    classes = [
        NAME_TO_CLASS[c] if isinstance(c, str) else int(c) for c in current_classes
    ]
    compute_aos = any(
        len(dt["alpha"]) > 0 and dt["alpha"][0] != -10 for dt in dt_annos
    )
    results: Dict[str, float] = {}
    metric_names = {0: "bbox", 1: "bev", 2: "3d"}
    for cls in classes:
        cname = CLASS_TO_NAME[cls]
        for k in range(MIN_OVERLAPS.shape[0]):  # strict / loose overlap rows
            row = "" if k == 0 else "_loose"
            for metric in (0, 1, 2):
                for difficulty, dname in enumerate(("easy", "moderate", "hard")):
                    ret = eval_class(
                        gt_annos, dt_annos, cls, difficulty, metric,
                        MIN_OVERLAPS[k, metric, cls],
                        compute_aos=compute_aos and metric == 0,
                    )
                    base = f"{cname}_{metric_names[metric]}_{dname}{row}"
                    results[f"{base}_R11"] = map_r11(ret["precision"])
                    results[f"{base}_R40"] = map_r40(ret["precision"])
                    if compute_aos and metric == 0:
                        results[f"{cname}_aos_{dname}{row}_R11"] = map_r11(
                            ret["orientation"]
                        )
                        results[f"{cname}_aos_{dname}{row}_R40"] = map_r40(
                            ret["orientation"]
                        )
    return results


# coco-style per-class IoU-overlap sweeps (reference eval.py:754-800
# get_coco_eval_result / :634 do_coco_style_eval): AP averaged over a
# 10-point linspace of min-overlaps per class
CLASS_TO_RANGE = {
    0: (0.5, 0.95, 10), 1: (0.25, 0.7, 10), 2: (0.25, 0.7, 10),
    3: (0.5, 0.95, 10), 4: (0.25, 0.7, 10),
}


def get_coco_eval_result(gt_annos: List[dict], dt_annos: List[dict],
                         current_classes: Sequence) -> Dict[str, float]:
    classes = [
        NAME_TO_CLASS[c] if isinstance(c, str) else int(c) for c in current_classes
    ]
    compute_aos = any(
        len(dt["alpha"]) > 0 and dt["alpha"][0] != -10 for dt in dt_annos
    )
    metric_names = {0: "bbox", 1: "bev", 2: "3d"}
    results: Dict[str, float] = {}
    for cls in classes:
        cname = CLASS_TO_NAME[cls]
        lo, hi, n = CLASS_TO_RANGE[cls]
        overlaps = np.linspace(lo, hi, int(n))
        for metric in (0, 1, 2):
            for difficulty, dname in enumerate(("easy", "moderate", "hard")):
                r11, r40, aos11, aos40 = [], [], [], []
                for ov in overlaps:
                    ret = eval_class(
                        gt_annos, dt_annos, cls, difficulty, metric, float(ov),
                        compute_aos=compute_aos and metric == 0,
                    )
                    r11.append(map_r11(ret["precision"]))
                    r40.append(map_r40(ret["precision"]))
                    if compute_aos and metric == 0:
                        aos11.append(map_r11(ret["orientation"]))
                        aos40.append(map_r40(ret["orientation"]))
                base = f"{cname}_{metric_names[metric]}_{dname}_coco"
                results[f"{base}_R11"] = float(np.mean(r11))
                results[f"{base}_R40"] = float(np.mean(r40))
                if aos11:
                    results[f"{cname}_aos_{dname}_coco_R11"] = float(np.mean(aos11))
                    results[f"{cname}_aos_{dname}_coco_R40"] = float(np.mean(aos40))
    return results
