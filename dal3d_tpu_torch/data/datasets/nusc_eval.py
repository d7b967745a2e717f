"""nuScenes submission conversion and the devkit bridge (port of
``dal3d_tpu/data/datasets/nusc_eval.py``; host numpy, as there).

yaw -> -yaw - pi/2, z-axis quaternion, velocity (vx, vy, 0), the sensor ->
ego -> global transform through the info's stored matrices, and the
speed-threshold attribute heuristic. ``eval_main`` imports the official
devkit inside, as the JAX module does: where it is not installed the
``ImportError`` reaches ``NuScenesDataset.evaluation``, which then reports
the submission file alone.
"""
from __future__ import annotations

from typing import List

import numpy as np


def _quat_mult(q1, q2):
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _yaw_quat(yaw):
    return np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])


def _rotmat_to_quat(m):
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    i = np.argmax(np.diag(m))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(m[i, i] - m[j, j] - m[k, k] + 1.0) * 2
    q = np.zeros(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[i + 1] = 0.25 * s
    q[j + 1] = (m[j, i] + m[i, j]) / s
    q[k + 1] = (m[i, k] + m[k, i]) / s
    return q


def _quat_rot(q, v):
    w, x, y, z = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    return R @ v


_DEFAULT_ATTR = {
    "car": "vehicle.parked",
    "pedestrian": "pedestrian.moving",
    "trailer": "vehicle.parked",
    "truck": "vehicle.parked",
    "bus": "vehicle.moving",
    "motorcycle": "cycle.without_rider",
    "construction_vehicle": "vehicle.parked",
    "bicycle": "cycle.without_rider",
    "barrier": "",
    "traffic_cone": "",
}


def detections_to_nusc_boxes(det: dict, info: dict, class_names: List[str]) -> List[dict]:
    """One frame's padded detections -> list of nuScenes result dicts."""
    boxes = np.asarray(det["box3d_lidar"])  # [D, 9]
    scores = np.asarray(det["scores"])
    labels = np.asarray(det["label_preds"])
    valid = np.asarray(det.get("det_valid", scores > 0))

    # inverse of (ref_from_car @ car_from_global): sensor -> global
    ref_from_car = np.asarray(info["ref_from_car"]) if "ref_from_car" in info else np.eye(4)
    car_from_global = np.asarray(info["car_from_global"]) if "car_from_global" in info else np.eye(4)
    sensor2car = np.linalg.inv(ref_from_car)
    car2global = np.linalg.inv(car_from_global)

    q_s2c = _rotmat_to_quat(sensor2car[:3, :3])
    q_c2g = _rotmat_to_quat(car2global[:3, :3])

    results = []
    for i in np.flatnonzero(valid):
        x, y, z, w, l, h, vx, vy, yaw = boxes[i]
        yaw = -yaw - np.pi / 2
        quat = _yaw_quat(yaw)
        center = np.array([x, y, z + h / 2])  # storage z = bottom; nusc = center
        vel = np.array([vx, vy, 0.0])

        # sensor -> car
        center = _quat_rot(q_s2c, center) + sensor2car[:3, 3]
        quat = _quat_mult(q_s2c, quat)
        vel = _quat_rot(q_s2c, vel)
        # car -> global
        center = _quat_rot(q_c2g, center) + car2global[:3, 3]
        quat = _quat_mult(q_c2g, quat)
        vel = _quat_rot(q_c2g, vel)

        name = class_names[int(labels[i])]
        speed = float(np.sqrt(vel[0] ** 2 + vel[1] ** 2))
        if speed > 0.2 and name in ("car", "construction_vehicle", "bus", "truck", "trailer"):
            attr = "vehicle.moving"
        elif speed > 0.2 and name in ("bicycle", "motorcycle"):
            attr = "cycle.with_rider"
        else:
            attr = _DEFAULT_ATTR.get(name, "")

        results.append({
            "sample_token": info["token"],
            "translation": center.tolist(),
            "size": [float(w), float(l), float(h)],
            "rotation": quat.tolist(),
            "velocity": [float(vel[0]), float(vel[1])],
            "detection_name": name,
            "detection_score": float(scores[i]),
            "attribute_name": attr,
        })
    return results


def eval_main(res_path: str, root_path: str, version: str, eval_version: str, output_dir: str):
    """Shell into the official nuScenes devkit (host-side oracle,
    reference nusc_common.py:699-710). Raises ImportError when absent."""
    from nuscenes import NuScenes
    from nuscenes.eval.detection.config import config_factory
    from nuscenes.eval.detection.evaluate import NuScenesEval

    nusc = NuScenes(version=version, dataroot=root_path, verbose=False)
    cfg = config_factory(eval_version)
    nusc_eval = NuScenesEval(
        nusc, config=cfg, result_path=res_path,
        eval_set="val" if "trainval" in version else "mini_val",
        output_dir=output_dir, verbose=False,
    )
    metrics = nusc_eval.main(plot_examples=0, render_curves=False)
    return {"results": {"nusc": metrics}}
