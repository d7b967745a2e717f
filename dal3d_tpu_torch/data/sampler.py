"""GT-AUG database sampler, class-balanced paste augmentation (port of
``dal3d_tpu/data/sampler.py``; host numpy, as there).

- per class group, sample (max_sample_num - current_count) instances from the
  GT database (filtered by min points / difficulty),
- paste = load the object's cropped points from gt_database/*.bin, translate
  them to the box position, reject candidates whose BEV rectangle collides
  with any existing or previously pasted box (exact convex-polygon overlap:
  vertex containment or edge intersection, ``box_collision_test``),
- the config's ``enable`` flag is not read: as in the JAX package, GT-AUG is
  on whenever the database exists.

The JAX package takes its native host library's collision test when that is
built; the port always takes the numpy one, which gives the same booleans.
Every draw comes from numpy's global generator (or the ``rng`` given) in the
JAX package's order: one shuffle per class at construction, in the dict
order of the db infos, then the per-class samplers' reshuffles.
"""
from __future__ import annotations

import copy
import pathlib
from typing import Dict, List

import numpy as np

from ..core import box_np_ops
from ..utils.fileio import load


def _segments_intersect(a0, a1, b0, b1):
    """Vectorized proper segment intersection. a*: [..., 2], b*: [..., 2]."""

    def cross(o, p, q):
        return (p[..., 0] - o[..., 0]) * (q[..., 1] - o[..., 1]) - (
            p[..., 1] - o[..., 1]
        ) * (q[..., 0] - o[..., 0])

    d1 = cross(b0, b1, a0)
    d2 = cross(b0, b1, a1)
    d3 = cross(a0, a1, b0)
    d4 = cross(a0, a1, b1)
    return ((d1 * d2) < 0) & ((d3 * d4) < 0)


def _point_in_quad(pts, quad):
    """pts [..., 2], quad [..., 4, 2] convex -> bool[...] via sign-consistency."""
    s = []
    for i in range(4):
        a = quad[..., i, :]
        b = quad[..., (i + 1) % 4, :]
        s.append(
            (b[..., 0] - a[..., 0]) * (pts[..., 1] - a[..., 1])
            - (b[..., 1] - a[..., 1]) * (pts[..., 0] - a[..., 0])
        )
    s = np.stack(s, -1)
    return np.all(s >= 0, -1) | np.all(s <= 0, -1)


def box_collision_test(boxes_corners: np.ndarray, qboxes_corners: np.ndarray) -> np.ndarray:
    """[N,4,2] vs [K,4,2] -> bool [N,K] BEV polygon overlap."""
    N, K = boxes_corners.shape[0], qboxes_corners.shape[0]
    if N == 0 or K == 0:
        return np.zeros((N, K), bool)
    # standup prefilter
    a_st = box_np_ops.corner_to_standup_nd(boxes_corners)
    b_st = box_np_ops.corner_to_standup_nd(qboxes_corners)
    iw = np.minimum(a_st[:, None, 2], b_st[None, :, 2]) - np.maximum(a_st[:, None, 0], b_st[None, :, 0])
    ih = np.minimum(a_st[:, None, 3], b_st[None, :, 3]) - np.maximum(a_st[:, None, 1], b_st[None, :, 1])
    cand = (iw > 0) & (ih > 0)

    # vertex containment both ways
    inside_ab = _point_in_quad(
        boxes_corners[:, None, :, :], qboxes_corners[None, :, None, :, :]
    ).any(-1)
    inside_ba = _point_in_quad(
        qboxes_corners[None, :, :, :], boxes_corners[:, None, None, :, :]
    ).any(-1)

    # edge intersection: [N,K,4,4]
    a0 = boxes_corners[:, None, :, None, :]
    a1 = np.roll(boxes_corners, -1, axis=1)[:, None, :, None, :]
    b0 = qboxes_corners[None, :, None, :, :]
    b1 = np.roll(qboxes_corners, -1, axis=1)[None, :, None, :, :]
    edges = _segments_intersect(a0, a1, b0, b1).any((-1, -2))

    return cand & (inside_ab | inside_ba | edges)


class BatchSampler:
    """Shuffled epoch-cycling sampler over one class's db infos
    (reference sample_ops.py BatchSampler)."""

    def __init__(self, sampled_list: List[dict], name: str, shuffle: bool = True, rng=None):
        self._sampled_list = sampled_list
        self._indices = np.arange(len(sampled_list))
        self._rng = rng or np.random
        self._shuffle = shuffle
        if shuffle:
            self._rng.shuffle(self._indices)
        self._idx = 0
        self._name = name

    def sample(self, num: int) -> List[dict]:
        if num == 0 or len(self._sampled_list) == 0:
            return []
        out = []
        while len(out) < num:
            if self._idx >= len(self._indices):
                self._idx = 0
                if self._shuffle:
                    self._rng.shuffle(self._indices)
            out.append(self._sampled_list[self._indices[self._idx]])
            self._idx += 1
        return out


class DataBaseSamplerV2:
    def __init__(
        self,
        db_infos: Dict[str, List[dict]] | str,
        groups: List[Dict[str, int]],
        db_prepor=None,
        rate: float = 1.0,
        rng=None,
    ):
        if isinstance(db_infos, str):
            db_infos = load(db_infos)
        if db_prepor is not None:
            db_infos = db_prepor(db_infos)
        self.db_infos = db_infos
        self.rate = rate
        self._rng = rng or np.random
        self._groups = groups
        self._sample_classes: List[str] = []
        self._sample_max_nums: List[int] = []
        for group in groups:
            self._sample_classes += list(group.keys())
            self._sample_max_nums += list(group.values())
        self._samplers = {
            k: BatchSampler(v, k, rng=self._rng) for k, v in db_infos.items()
        }

    def sample_all(self, root_path, gt_boxes, gt_names, num_point_features=5):
        """Returns None or dict(gt_names, gt_boxes, points, gt_masks)."""
        sampled_num_dict = {}
        sample_num_per_class = []
        for class_name, max_sample_num in zip(self._sample_classes, self._sample_max_nums):
            sampled_num = int(
                max_sample_num - np.sum([n == class_name for n in gt_names])
            )
            sampled_num = np.round(self.rate * sampled_num).astype(np.int64)
            sampled_num_dict[class_name] = sampled_num
            sample_num_per_class.append(sampled_num)

        sampled: List[dict] = []
        sampled_gt_boxes = []
        avoid_coll_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, gt_boxes.shape[-1] if len(gt_boxes) else 9)

        for class_name, sampled_num in zip(self._sample_classes, sample_num_per_class):
            if sampled_num > 0 and class_name in self._samplers:
                sampled_cls = self._sample_class(class_name, sampled_num, avoid_coll_boxes)
                sampled += sampled_cls
                if len(sampled_cls) > 0:
                    boxes = np.stack([s["box3d_lidar"] for s in sampled_cls], axis=0)
                    sampled_gt_boxes.append(boxes)
                    avoid_coll_boxes = np.concatenate([avoid_coll_boxes, boxes], axis=0)

        if len(sampled) == 0:
            return None
        sampled_gt_boxes = np.concatenate(sampled_gt_boxes, axis=0)
        s_points_list = []
        for info in sampled:
            if "points" in info:  # inline points (synthetic/test dbs)
                s_points = np.array(info["points"], np.float32).copy()
            else:
                p = pathlib.Path(root_path) / info["path"]
                s_points = np.fromfile(str(p), dtype=np.float32).reshape(
                    -1, num_point_features
                )
            s_points[:, :3] += info["box3d_lidar"][:3]
            s_points_list.append(s_points)
        return {
            "gt_names": np.array([s["name"] for s in sampled]),
            "gt_boxes": sampled_gt_boxes,
            "points": np.concatenate(s_points_list, axis=0)
            if s_points_list
            else np.zeros((0, num_point_features), np.float32),
            "gt_masks": np.ones((len(sampled),), dtype=bool),
        }

    def _sample_class(self, name, num, gt_boxes):
        """sample_class_v2 (:253-300): collision-reject candidates vs existing
        + earlier-accepted boxes."""
        sampled = copy.deepcopy(self._samplers[name].sample(num))
        num_gt = gt_boxes.shape[0]
        if len(sampled) == 0:
            return []
        sp_boxes = np.stack([i["box3d_lidar"] for i in sampled], axis=0)
        boxes = np.concatenate([gt_boxes, sp_boxes], axis=0).copy()

        yaw = boxes[:, -1]
        corners = box_np_ops.center_to_corner_box2d(boxes[:, 0:2], boxes[:, 3:5], yaw)
        coll_mat = box_collision_test(corners, corners)
        diag = np.arange(boxes.shape[0])
        coll_mat[diag, diag] = False

        valid_samples = []
        for i in range(num_gt, num_gt + len(sampled)):
            if coll_mat[i].any():
                coll_mat[i] = False
                coll_mat[:, i] = False
            else:
                valid_samples.append(sampled[i - num_gt])
        return valid_samples


def filter_by_min_points(db_infos: dict, min_points_dict: Dict[str, int]) -> dict:
    out = dict(db_infos)
    for name, min_num in min_points_dict.items():
        if min_num > 0 and name in out:
            out[name] = [info for info in out[name] if info["num_points_in_gt"] >= min_num]
    return out


def filter_by_difficulty(db_infos: dict, removed: List[int]) -> dict:
    return {
        name: [info for info in infos if info.get("difficulty", 0) not in removed]
        for name, infos in db_infos.items()
    }


def build_db_preprocessors(db_prep_steps: List[dict]):
    funcs = []
    for step in db_prep_steps:
        step = dict(step)
        if "filter_by_min_num_points" in step:
            arg = step["filter_by_min_num_points"]
            funcs.append(lambda d, a=arg: filter_by_min_points(d, a))
        if "filter_by_difficulty" in step:
            arg = step["filter_by_difficulty"]
            funcs.append(lambda d, a=arg: filter_by_difficulty(d, a))

    def apply(d):
        for f in funcs:
            d = f(d)
        return d

    return apply
