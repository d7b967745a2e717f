"""Matched-prediction quality evaluator, the "classwise_weight" subsystem
(port of ``dal3d_tpu/eval/matched_iou.py``; host numpy and scipy, as
there).

Instead of computing AP, record for every matched prediction its class name,
detection score, **scale IoU** with the matched box, and the matched box's
score (``ref_score``) into a per-frame dict, consumed by the PPAL per-class
difficulty weights and the CALD consistency + JS-divergence ranking.

Matching is greedy by descending confidence under a center-distance threshold
(nuScenes convention). The "reference side" can be GT boxes (PPAL) or a second
prediction set, e.g. on augmented inputs (CALD).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def scale_iou(size_a: Sequence[float], size_b: Sequence[float]) -> float:
    """Size-aligned 3D IoU (nuScenes scale_iou): boxes aligned in
    translation+rotation, IoU of the axis-aligned size boxes."""
    sa = np.maximum(np.asarray(size_a, np.float64), 1e-9)
    sb = np.maximum(np.asarray(size_b, np.float64), 1e-9)
    inter = float(np.prod(np.minimum(sa, sb)))
    union = float(np.prod(sa)) + float(np.prod(sb)) - inter
    return inter / union


# detection_cvpr_2019 per-class eval ranges (devkit config); the reference
# filters both box sets to these before matching (classwise_weight/
# evaluate.py:93-96 filter_eval_boxes with self.cfg.class_range)
CLASS_RANGE = {
    "car": 50.0, "truck": 50.0, "bus": 50.0, "trailer": 50.0,
    "construction_vehicle": 50.0, "pedestrian": 40.0, "motorcycle": 40.0,
    "bicycle": 40.0, "traffic_cone": 30.0, "barrier": 30.0,
}


def accumulate_matches(
    ref_frames: Dict[str, dict],
    pred_frames: Dict[str, dict],
    class_names: List[str],
    dist_th: float = 1.0,
    class_range: Dict[str, float] = None,
) -> Dict[str, dict]:
    """Greedy confidence-ordered matching per class.

    dist_th 1.0 m and the per-class range filter replicate the reference
    exactly (classwise_weight/evaluate.py:116 hardcodes dist_th=1.0 with the
    cfg.dist_ths sweep commented out). Range filtering replicates the
    devkit's ego_dist: BEV distance from the ego (car) origin, read from each
    frame's ``ego_xy`` (attached by infos_to_frames from ref_from_car);
    frames without it fall back to lidar-origin distance.

    ref_frames / pred_frames: token -> dict(boxes [N, >=7] (x,y,... first two
    are the match centers), names [N] str, scores [N]; ref score defaults 1.0
    for GT). Returns token -> {name, detection_score, iou, ref_score} lists.
    """
    if class_range is None:
        class_range = CLASS_RANGE
    dict_p_iou: Dict[str, dict] = {}
    for class_name in class_names:
        max_range = float(class_range.get(class_name, np.inf))
        # flatten all predictions of this class, sort by confidence desc
        entries = []
        for token, pf in pred_frames.items():
            names = np.asarray(pf["names"])
            if len(names) == 0:
                continue
            boxes = np.asarray(pf["boxes"], np.float64).reshape(len(names), -1)
            rf0 = ref_frames.get(token) or {}
            ex, ey = pf.get("ego_xy", rf0.get("ego_xy", (0.0, 0.0)))
            for i in np.flatnonzero(names == class_name):
                if np.hypot(boxes[i, 0] - ex, boxes[i, 1] - ey) > max_range:
                    continue
                entries.append((float(pf["scores"][i]), token, int(i)))
        entries.sort(key=lambda e: -e[0])

        taken = set()
        for score, token, pi in entries:
            rf = ref_frames.get(token)
            if rf is None:
                continue
            rnames = np.asarray(rf["names"])
            cand = np.flatnonzero(rnames == class_name)
            best, best_d = None, np.inf
            pbox = np.asarray(pred_frames[token]["boxes"][pi])
            ex, ey = rf.get("ego_xy", (0.0, 0.0))
            for gi in cand:
                if (token, int(gi)) in taken:
                    continue
                gbox = np.asarray(rf["boxes"][gi])
                if np.hypot(gbox[0] - ex, gbox[1] - ey) > max_range:  # ego_dist filter
                    continue
                d = float(np.hypot(pbox[0] - gbox[0], pbox[1] - gbox[1]))
                if d < best_d:
                    best_d, best = d, int(gi)
            if best is None or best_d >= dist_th:
                continue
            taken.add((token, best))
            gbox = np.asarray(rf["boxes"][best])
            rec = dict_p_iou.setdefault(
                token, {"name": [], "detection_score": [], "iou": [], "ref_score": []}
            )
            rec["name"].append(class_name)
            rec["detection_score"].append(float(score))
            rec["iou"].append(scale_iou(pbox[3:6], gbox[3:6]))
            ref_scores = rf.get("scores")
            rec["ref_score"].append(float(ref_scores[best]) if ref_scores is not None else 1.0)
    return dict_p_iou


def detections_to_frames(detections: Dict[str, dict], class_names: List[str]) -> Dict[str, dict]:
    """Padded device detections -> matching-ready frame dicts."""
    out = {}
    for token, det in detections.items():
        valid = np.asarray(det["det_valid"]).astype(bool)
        labels = np.asarray(det["label_preds"])[valid]
        out[token] = {
            "boxes": np.asarray(det["box3d_lidar"])[valid],
            "names": np.asarray([class_names[int(l)] for l in labels]),
            "scores": np.asarray(det["scores"])[valid],
        }
    return out


def infos_to_frames(infos: List[dict]) -> Dict[str, dict]:
    """GT infos -> matching-ready frame dicts (scores None -> ref 1.0).

    Attaches ``ego_xy``, the car origin in the lidar frame (= translation of
    ``ref_from_car``), so the range filter can replicate the devkit's
    ego_dist exactly instead of approximating with lidar-origin distance."""
    out = {}
    for info in infos:
        frame = {
            "boxes": np.asarray(info["gt_boxes"], np.float32).reshape(-1, 9),
            "names": np.asarray(info["gt_names"]),
            "scores": None,
        }
        rfc = info.get("ref_from_car")
        if rfc is not None:
            frame["ego_xy"] = np.asarray(rfc, np.float64)[:2, 3]
        out[info["token"]] = frame
    return out


def ppal_difficulty_weights(
    dict_p_iou: Dict[str, dict],
    tokens_subset: List[str] | None = None,
    alpha: float = 3.0,
    ub: float = 2.0,
) -> Dict[str, float]:
    """Per-class difficulty weights (reference tools/ppal_unc.py:74-100):
    quality = score^0.6 * iou^0.4; weight = 1 + a*log(b*(1-avg_q)+1)*ub."""
    records = (
        [dict_p_iou[t] for t in tokens_subset if t in dict_p_iou]
        if tokens_subset is not None
        else list(dict_p_iou.values())
    )
    csum: Dict[str, float] = {}
    ccount: Dict[str, int] = {}
    for rec in records:
        for name, score, iou in zip(rec["name"], rec["detection_score"], rec["iou"]):
            q = (score**0.6) * (iou**0.4)
            csum[name] = csum.get(name, 0.0) + q
            ccount[name] = ccount.get(name, 0) + 1
    b = np.exp(1.0 / alpha) - 1
    return {
        name: 1 + alpha * np.log(b * (1.0 - csum[name] / ccount[name]) + 1) * ub
        for name in csum
    }


def cald_consistency(
    dict_p_iou: Dict[str, dict], all_tokens: List[str]
) -> tuple[Dict[str, float], List[int]]:
    """Per-frame CALD consistency (reference tools/cald_ent.py:79-95):
    consistency = min over matches of |iou + 0.5*(1-js)*(p+q) - 1.3| with
    js the scalar-score JS divergence. Returns (token->consistency, frame
    indices sorted ascending by consistency)."""
    import scipy.stats

    cons: Dict[str, float] = {}
    for token in all_tokens:
        c = 2.0  # reference init consistency_img = 2
        rec = dict_p_iou.get(token)
        if rec:
            for iou, q, p in zip(rec["iou"], rec["detection_score"], rec["ref_score"]):
                m = (p + q) / 2
                js = 0.5 * scipy.stats.entropy(p, m) + 0.5 * scipy.stats.entropy(q, m)
                js = max(js, 0.0)
                c = min(c, abs(iou + 0.5 * (1 - js) * (p + q) - 1.3))
        cons[token] = c
    order = sorted(range(len(all_tokens)), key=lambda i: cons[all_tokens[i]])
    return cons, order


def class_distribution_jsdiv(
    dict_p_iou: Dict[str, dict], all_tokens: List[str], class_names: List[str]
) -> Dict[int, float]:
    """idx -> JS divergence between the frame's matched-class histogram and
    the global class distribution (reference cald_ent.py:96-167)."""
    import scipy.stats

    n = len(class_names)
    name_to_cls = {c: i for i, c in enumerate(class_names)}
    global_count = np.zeros(n)
    per_frame = {}
    for i, token in enumerate(all_tokens):
        hist = np.zeros(n)
        rec = dict_p_iou.get(token)
        if rec:
            for name in rec["name"]:
                if name in name_to_cls:
                    hist[name_to_cls[name]] += 1
        per_frame[i] = hist
        global_count += hist
    gdist = global_count / max(global_count.sum(), 1)
    out = {}
    for i, hist in per_frame.items():
        if hist.sum() == 0:
            out[i] = 1.0
            continue
        p = hist / hist.sum()
        m = (p + gdist) / 2
        js = 0.5 * scipy.stats.entropy(p, m) + 0.5 * scipy.stats.entropy(gdist, m)
        out[i] = float(max(js, 0.0))
    return out
