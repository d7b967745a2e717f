"""BEV map-segmentation targets (port of
``dal3d_tpu/data/pipelines/bev_seg.py``; reference bevfusion
mmdet3d/datasets/pipelines/loading.py:239 ``LoadBEVSegmentation``).

Rasterises the map layers into per-class masks [C, Wc, Hc] (x cells, then y
cells; float32 0 / 1), aligned with the augmented lidar frame through
``res["lidar"]["aug_matrix"]`` and the info's ``car_from_global`` /
``ref_from_car``. Two sources, as in JAX:

- the nuScenes map API (``map_location`` in the info and a ``dataset_root``):
  patch box and angle from lidar -> global, ``get_map_mask`` per layer, the
  class -> layer map. The devkit is imported lazily; without it the stage
  falls back to the synthetic masks, and a map file the devkit cannot read
  is logged as a warning and falls back too;
- a procedural synthetic map: deterministic global-frame functions (road
  bands, dividers, crossings, walkways, stop lines, car parks) evaluated at
  each cell centre through the same lidar -> global chain, in float64.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

CLASS2LAYERS = {
    "drivable_area": ["drivable_area"],
    "drivable_area*": ["road_segment", "lane"],
    "ped_crossing": ["ped_crossing"],
    "walkway": ["walkway"],
    "stop_line": ["stop_line"],
    "carpark_area": ["carpark_area"],
    "divider": ["road_divider", "lane_divider"],
}


def _lidar_to_global(info: dict, aug: Optional[np.ndarray]) -> np.ndarray:
    """4x4 map of augmented-lidar coordinates -> global: the inverse of
    ref_from_car @ car_from_global, then the inverse of the lidar
    augmentation (p_lidar = A^-1 p_aug)."""
    m = np.eye(4, dtype=np.float64)
    cfg_ = info.get("car_from_global")
    rfc = info.get("ref_from_car")
    if cfg_ is not None and rfc is not None:
        m = np.linalg.inv(np.asarray(rfc) @ np.asarray(cfg_))
    if aug is not None:
        a4 = np.eye(4)
        a4[:3, :3] = np.linalg.inv(np.asarray(aug, np.float64))
        m = m @ a4
    return m


def synthetic_map_masks(xy_global: np.ndarray, classes: Sequence[str]) -> np.ndarray:
    """The procedural map at global points [..., 2] -> [C, ...] float32."""
    x, y = xy_global[..., 0], xy_global[..., 1]
    ym = np.mod(y, 40.0) - 20.0  # a road band every 40 m, half-width 8
    xm = np.mod(x, 30.0)
    road = np.abs(ym) < 8.0
    layers = {
        "drivable_area": road,
        "drivable_area*": road,
        "divider": np.abs(ym) < 0.3,
        "ped_crossing": road & (xm < 2.0),
        "stop_line": road & (np.abs(xm - 4.0) < 0.8),
        "walkway": (np.abs(ym) >= 8.0) & (np.abs(ym) < 11.0),
        "carpark_area": (np.abs(ym) >= 11.0) & (np.abs(ym) < 16.0) & (xm < 10.0),
    }
    return np.stack([layers[c] for c in classes]).astype(np.float32)


class LoadBEVSegmentation:
    def __init__(self, xbound: Tuple[float, float, float], ybound: Tuple[float, float, float],
                 classes: Sequence[str] = ("drivable_area", "ped_crossing", "walkway",
                                           "stop_line", "carpark_area", "divider"),
                 dataset_root: str = "", **kwargs):
        self.classes = list(classes)
        self.xbound, self.ybound = xbound, ybound
        self.canvas = (  # (Wc, Hc) = (x cells, y cells)
            int(round((xbound[1] - xbound[0]) / xbound[2])),
            int(round((ybound[1] - ybound[0]) / ybound[2])),
        )
        self.patch = (ybound[1] - ybound[0], xbound[1] - xbound[0])
        self.dataset_root = dataset_root
        self._maps: Dict[str, object] = {}

    def _nusc_map(self, location: str):
        if location not in self._maps:
            from nuscenes.map_expansion.map_api import NuScenesMap

            self._maps[location] = NuScenesMap(self.dataset_root, location)
        return self._maps[location]

    def _devkit_masks(self, info: dict, l2g: np.ndarray) -> np.ndarray:
        pose = l2g[:2, 3]
        v = l2g[:3, :3] @ np.array([1.0, 0, 0])
        patch_angle = np.arctan2(v[1], v[0]) / np.pi * 180
        layer_names = sorted({name for c in self.classes for name in CLASS2LAYERS[c]})
        masks = self._nusc_map(info["map_location"]).get_map_mask(
            patch_box=(pose[0], pose[1], self.patch[0], self.patch[1]),
            patch_angle=patch_angle,
            layer_names=layer_names,
            canvas_size=(self.canvas[1], self.canvas[0]),
        ).transpose(0, 2, 1).astype(bool)
        labels = np.zeros((len(self.classes), *self.canvas), np.float32)
        for k, c in enumerate(self.classes):
            for name in CLASS2LAYERS[c]:
                labels[k][masks[layer_names.index(name)]] = 1.0
        return labels

    def _synthetic_masks(self, l2g: np.ndarray) -> np.ndarray:
        Wc, Hc = self.canvas
        xs = self.xbound[0] + (np.arange(Wc) + 0.5) * self.xbound[2]
        ys = self.ybound[0] + (np.arange(Hc) + 0.5) * self.ybound[2]
        gx, gy = np.meshgrid(xs, ys, indexing="ij")  # [Wc, Hc], augmented lidar frame
        pts = np.stack([gx, gy, np.zeros_like(gx), np.ones_like(gx)], -1)
        glob = pts @ l2g.T  # [Wc, Hc, 4]
        return synthetic_map_masks(glob[..., :2], self.classes)

    def __call__(self, res: dict, info: dict):
        aug = res.get("lidar", {}).get("aug_matrix")
        l2g = _lidar_to_global(info, aug)
        if info.get("map_location") and self.dataset_root:
            try:
                res["gt_masks_bev"] = self._devkit_masks(info, l2g)
                return res, info
            except ImportError:
                pass
            except (OSError, ValueError, KeyError) as e:
                # a devkit without readable map files must not stop training
                logging.getLogger("dal3d").warning(
                    "devkit map load failed (%s: %s); using synthetic masks",
                    type(e).__name__, e)
        res["gt_masks_bev"] = self._synthetic_masks(l2g)
        return res, info
