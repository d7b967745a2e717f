"""Host-side (numpy) point/box augmentation primitives (port of
``dal3d_tpu/data/pipelines/augment.py``; every draw comes from numpy's global
generator in the same order, so one seed gives both packages one batch).

Behavioral parity with det3d/core/sampler/preprocess.py:
- random_flip_both (:829-854): independent y-axis then x-axis flips (p=0.5),
- global_rotation (:796-813): shared z-rotation of points, box centers,
  velocities; yaw += angle,
- global_scaling_v2 (:857-861): uniform scale of everything but yaw,
- global_translate (:962-985): gaussian translation (configured but unused by
  the reference Preprocess — kept for completeness),
- noise_per_object (:587-709): per-object jitter with num_try candidate
  poses + BEV collision accept/reject, full nonzero-noise semantics (KITTI
  -style configs); still a cheap identity under the canonical CBGS configs
  (gt_loc_noise = 0, gt_rot_noise = 0).

All functions mutate copies and return (gt_boxes, points).
"""
from __future__ import annotations

import numpy as np

from ...core import box_np_ops


def _rot_z(pts, angle):
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s], [s, c]], dtype=pts.dtype)
    out = pts.copy()
    out[:, :2] = pts[:, :2] @ rot  # x' = x c + y s ; y' = -x s + y c
    return out


def random_flip_both(gt_boxes, points, probability=0.5, rng=None, record=None):
    rng = rng or np.random
    if rng.uniform() < probability:  # y := -y
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, -1] = -gt_boxes[:, -1] + np.pi
        points[:, 1] = -points[:, 1]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 7] = -gt_boxes[:, 7]
        if record is not None:
            record["flip_y"] = True
    if rng.uniform() < probability:  # x := -x
        gt_boxes[:, 0] = -gt_boxes[:, 0]
        points[:, 0] = -points[:, 0]
        gt_boxes[:, -1] = -gt_boxes[:, -1] + 2 * np.pi
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 6] = -gt_boxes[:, 6]
        if record is not None:
            record["flip_x"] = True
    return gt_boxes, points


def global_rotation(gt_boxes, points, rotation=(-np.pi / 4, np.pi / 4), rng=None, record=None):
    rng = rng or np.random
    if not isinstance(rotation, (list, tuple, np.ndarray)):
        rotation = (-rotation, rotation)
    angle = rng.uniform(rotation[0], rotation[1])
    if record is not None:
        record["rotation"] = float(angle)
    points[:, :2] = _rot_z(points[:, :3], angle)[:, :2]
    gt_boxes[:, :2] = _rot_z(gt_boxes[:, :3], angle)[:, :2]
    if gt_boxes.shape[1] > 7:
        gt_boxes[:, 6:8] = _rot_z(
            np.hstack([gt_boxes[:, 6:8], np.zeros((gt_boxes.shape[0], 1), gt_boxes.dtype)]), angle
        )[:, :2]
    gt_boxes[:, -1] += angle
    return gt_boxes, points


def global_scaling_v2(gt_boxes, points, min_scale=0.95, max_scale=1.05, rng=None, record=None):
    rng = rng or np.random
    s = rng.uniform(min_scale, max_scale)
    if record is not None:
        record["scale"] = float(s)
    points[:, :3] *= s
    gt_boxes[:, :-1] *= s
    return gt_boxes, points


def global_translate(gt_boxes, points, noise_std=(0.2, 0.2, 0.2), rng=None):
    rng = rng or np.random
    noise_std = np.asarray(noise_std, np.float64)
    if np.all(noise_std == 0):
        return gt_boxes, points
    t = np.array([rng.normal(0, noise_std[0]), rng.normal(0, noise_std[1]), rng.normal(0, noise_std[2])])
    points[:, :3] += t
    gt_boxes[:, :3] += t
    return gt_boxes, points


def noise_per_object(gt_boxes, points, valid_mask=None, rotation_perturb=(0.0, 0.0),
                     center_noise_std=(0.0, 0.0, 0.0), num_try=100, rng=None):
    """Per-object pose jitter with collision-tested candidate accept/reject.

    Full parity with det3d/core/sampler/preprocess.py noise_per_object_v3_
    (:587-709) + noise_per_box (:239-267) + points_transform_ (:451-467) +
    box3d_transform_ (:471-476), group_ids/global-rot-range paths excluded
    (unused by every shipped config):
    - num_try (loc, rot) candidates are drawn per box up front,
    - candidates are tried in order; the first whose jittered BEV footprint
      collides with NO other box (earlier boxes at their already-jittered
      poses) is accepted, else the box keeps its pose (noise = 0),
    - each point moves with the FIRST valid box containing it (membership
      from the ORIGINAL poses): rotate about the old box center, then shift.

    The reference's numba corner loop collapses into the repo's vectorized
    polygon collision (data/sampler.box_collision_test); candidate corners
    come from the same center_to_corner_box2d the membership test uses, so
    rotation conventions cannot diverge. Boxes are [N, >=7] with yaw LAST
    (velocities at 6:8 untouched: per-object jitter does not re-aim them —
    matches box3d_transform_, which only edits loc and yaw). Mutates
    gt_boxes/points in place (like the reference) and returns them.
    """
    from ..sampler import box_collision_test

    if not isinstance(rotation_perturb, (list, tuple, np.ndarray)):
        rotation_perturb = [-rotation_perturb, rotation_perturb]
    if not isinstance(center_noise_std, (list, tuple, np.ndarray)):
        center_noise_std = [center_noise_std] * 3
    if np.all(np.asarray(rotation_perturb) == 0) and np.all(
        np.asarray(center_noise_std) == 0
    ):
        return gt_boxes, points
    rng = rng or np.random
    n = gt_boxes.shape[0]
    if n == 0:
        return gt_boxes, points
    if valid_mask is None:
        valid_mask = np.ones(n, bool)

    loc_noises = rng.normal(
        scale=np.maximum(np.asarray(center_noise_std, np.float64), 1e-12),
        size=[n, num_try, 3],
    )
    rot_noises = rng.uniform(rotation_perturb[0], rotation_perturb[1], size=[n, num_try])

    # point membership from the ORIGINAL poses (reference builds surfaces
    # from the pre-noise corners)
    point_masks = box_np_ops.points_in_rbbox(points, gt_boxes)

    corners = box_np_ops.center_to_corner_box2d(
        gt_boxes[:, :2], gt_boxes[:, 3:5], gt_boxes[:, -1]
    )  # [N, 4, 2] — updated in place as boxes accept their jitter
    selected = np.full(n, -1, np.int64)
    CHUNK = 8  # candidate batch: vectorized inner test, early exit like the ref
    for i in range(n):
        if not valid_mask[i]:
            continue
        for j0 in range(0, num_try, CHUNK):
            js = np.arange(j0, min(j0 + CHUNK, num_try))
            cand = box_np_ops.center_to_corner_box2d(
                gt_boxes[i, :2] + loc_noises[i, js, :2],
                np.broadcast_to(gt_boxes[i, 3:5], (len(js), 2)),
                gt_boxes[i, -1] + rot_noises[i, js],
            )  # [T, 4, 2]
            coll = box_collision_test(cand, corners)
            coll[:, i] = False
            ok = ~coll.any(axis=1)
            if ok.any():
                j = int(js[np.argmax(ok)])
                selected[i] = j
                corners[i] = box_np_ops.center_to_corner_box2d(
                    gt_boxes[i, None, :2] + loc_noises[i, None, j, :2],
                    gt_boxes[i, None, 3:5],
                    gt_boxes[i, None, -1] + rot_noises[i, None, j],
                )[0]
                break

    chose = selected >= 0
    sel = np.where(chose, selected, 0)
    loc_t = np.where(chose[:, None], loc_noises[np.arange(n), sel], 0.0)
    rot_t = np.where(chose, rot_noises[np.arange(n), sel], 0.0)

    # move points with the FIRST valid box containing them
    eff = point_masks & valid_mask[None, :]
    has = eff.any(axis=1)
    first = np.argmax(eff, axis=1)
    for b in np.unique(first[has]):
        if not chose[b]:
            continue
        psel = has & (first == b)
        pts = points[psel]
        pts[:, :3] -= gt_boxes[b, :3]
        pts[:, :2] = _rot_z(pts[:, :3], rot_t[b])[:, :2]
        pts[:, :3] += gt_boxes[b, :3] + loc_t[b]
        points[psel] = pts

    gt_boxes[:, :3] += loc_t
    gt_boxes[:, -1] += rot_t
    return gt_boxes, points
