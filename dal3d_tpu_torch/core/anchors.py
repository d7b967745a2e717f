"""Anchor generation for the CBGS multi-task head (port of
``dal3d_tpu/core/anchors.py``, with its own copy of
``box_np_ops.create_anchors_3d_range``).

The anchor grid is static per config and built once with numpy. Per-task
layout (parity-critical): anchors [D*H*W*num_classes*num_rot, ndim] flattened
row-major in (H, W, class, rot) order, the order the head's NHWC predictions
flatten in.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


def create_anchors_3d_range(feature_size, anchor_range, sizes=(1.6, 3.9, 1.56),
                            rotations=(0, np.pi / 2), velocities=None,
                            dtype=np.float32) -> np.ndarray:
    """Dense anchor grid over a BEV feature map [D, H, W] (zyx) ->
    [D, H, W, num_size, num_rot, ndim], ndim 7, or 9 with velocities."""
    anchor_range = np.asarray(anchor_range, dtype)
    stride = (anchor_range[3] - anchor_range[0]) / feature_size[2]
    z_centers = np.linspace(anchor_range[2], anchor_range[5], feature_size[0], dtype=dtype)
    y_centers = np.linspace(anchor_range[1], anchor_range[4], feature_size[1],
                            endpoint=False, dtype=dtype) + stride / 2
    x_centers = np.linspace(anchor_range[0], anchor_range[3], feature_size[2],
                            endpoint=False, dtype=dtype) + stride / 2
    rotations = np.asarray(rotations, dtype=dtype)
    sizes = np.reshape(np.asarray(sizes, dtype=dtype), [-1, 3])
    if velocities is not None:
        velocities = np.asarray(velocities, dtype=dtype).reshape([-1, 2])
        combines = np.hstack([sizes, velocities]).reshape([-1, 5])
    else:
        combines = sizes
    rets = list(np.meshgrid(x_centers, y_centers, z_centers, rotations, indexing="ij"))
    tile_shape = [1] * 5
    tile_shape[-2] = int(sizes.shape[0])
    for i in range(len(rets)):
        rets[i] = np.tile(rets[i][..., np.newaxis, :], tile_shape)[..., np.newaxis]
    combines = np.reshape(combines, [1, 1, 1, -1, 1, combines.shape[-1]])
    tile_size_shape = list(rets[0].shape)
    tile_size_shape[3] = 1
    rets.insert(3, np.tile(combines, tile_size_shape))
    ret = np.concatenate(rets, axis=-1)
    # [x, y, z, size, rot] meshgrid order -> [z(D), y(H), x(W), size, rot]
    return np.transpose(ret, [2, 1, 0, 3, 4, 5])


@dataclass
class TaskAnchors:
    """Static per-task anchor bundle consumed by the head's loss and predict
    paths."""

    class_names: List[str]
    anchors: np.ndarray  # [A, ndim] in (D, H, W, class*rot) order
    # per-class stacked [C, A_c, ndim], A_c = D*H*W*num_rot (assignment view)
    anchors_by_class: np.ndarray
    matched_thresholds: np.ndarray  # [C]
    unmatched_thresholds: np.ndarray  # [C]
    feature_map_size: tuple  # (D, H, W)
    num_rot: int = 2

    @property
    def num_classes(self) -> int:
        return len(self.class_names)


def generate_task_anchors(anchor_generator_cfgs: Sequence[dict],
                          tasks: Sequence[dict],
                          feature_map_size: Sequence[int]) -> List[TaskAnchors]:
    """Per-task anchor bundles from the flat generator list, split across
    tasks by each task's num_class."""
    out: List[TaskAnchors] = []
    flag = 0
    for task in tasks:
        n = task["num_class"]
        gens = anchor_generator_cfgs[flag:flag + n]
        flag += n
        per_class = []  # each [D, H, W, num_rot, ndim]
        for g in gens:
            if g.get("type", "anchor_generator_range") not in (
                    "anchor_generator_range", "AnchorGeneratorRange"):
                raise ValueError(f"unknown anchor generator: {g['type']}")
            a = create_anchors_3d_range(
                feature_map_size, g["anchor_ranges"], g["sizes"],
                g.get("rotations", (0.0, np.pi / 2)), g.get("velocities"))
            per_class.append(a.reshape([*a.shape[:3], -1, a.shape[-1]]))
        interleaved = np.concatenate(per_class, axis=-2)  # [D, H, W, C*rot, ndim]
        by_class = np.stack([a.reshape(-1, a.shape[-1]) for a in per_class])
        out.append(TaskAnchors(
            class_names=list(task["class_names"]),
            anchors=interleaved.reshape(-1, interleaved.shape[-1]).astype(np.float32),
            anchors_by_class=by_class.astype(np.float32),
            matched_thresholds=np.asarray(
                [g.get("matched_threshold", -1.0) for g in gens], np.float32),
            unmatched_thresholds=np.asarray(
                [g.get("unmatched_threshold", -1.0) for g in gens], np.float32),
            feature_map_size=tuple(feature_map_size),
            num_rot=len(gens[0].get("rotations", (0.0, np.pi / 2))),
        ))
    return out
