"""Spatial+Feature and Spatial+Temporal+Feature combination selectors (port
of ``dal3d_tpu/selectors/combo_selectors.py``; reference det3d/selectors/spatial_feature_selector.py:188-197,
spatial_temporal_feature_selector.py:211-220): exp-normalize each map
(1 - exp(-d)) and combine with lambda weights, then budgeted FPS."""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import maps
from .geometry_selectors import SpatialSelector
from .registry import SELECTORS


@SELECTORS.register_module
class SpatialFeatureSelector(SpatialSelector):
    def __init__(self, *args, pred_store_file: Optional[str] = None,
                 distance_type: str = "l2_ref", lambda_f: float = 1.0,
                 aggregate: str = "sum", **kwargs):
        super().__init__(*args, **kwargs)
        self.pred_store_file = pred_store_file
        self.distance_type = distance_type
        self.lambda_f = lambda_f
        self.aggregate = aggregate

    def select_samples(self, **kwargs) -> None:
        spatial = maps.normalize_map(self.build_map(), "exp")
        s = self.run_pool_scoring(self.pred_store_file)
        feature = maps.normalize_map(
            maps.feature_map(s["embedding"], self.distance_type, device=self.device), "exp"
        )
        if self.aggregate == "sum":
            dm = spatial + self.lambda_f * feature
        elif self.aggregate == "min":
            dm = np.minimum(spatial, feature)
        else:
            dm = np.maximum(spatial, feature)
        dm = np.where(np.isfinite(dm), dm, 2.0)
        sampled = self.get_sampled()
        selected = self.kcenter_on_map(dm)
        self.selected_index[self.current_budget] = self.round_lineage() + selected


@SELECTORS.register_module
class SpatialTemporalFeatureSelector(SpatialSelector):
    def __init__(self, *args, pred_store_file: Optional[str] = None,
                 distance_type: str = "l2_ref", lambda_t: float = 1.0,
                 lambda_f: float = 1.0, **kwargs):
        super().__init__(*args, **kwargs)
        self.pred_store_file = pred_store_file
        self.distance_type = distance_type
        self.lambda_t = lambda_t
        self.lambda_f = lambda_f

    def select_samples(self, **kwargs) -> None:
        spatial = maps.normalize_map(self.build_map(), "exp")
        temporal, _ = maps.temporal_map(self.logfiles())
        temporal = maps.normalize_map(temporal, "exp")
        s = self.run_pool_scoring(self.pred_store_file)
        feature = maps.normalize_map(
            maps.feature_map(s["embedding"], self.distance_type, device=self.device), "exp"
        )
        dm = spatial + self.lambda_t * temporal + self.lambda_f * feature
        dm = np.where(np.isfinite(dm), dm, 3.0)
        sampled = self.get_sampled()
        selected = self.kcenter_on_map(dm)
        self.selected_index[self.current_budget] = self.round_lineage() + selected
