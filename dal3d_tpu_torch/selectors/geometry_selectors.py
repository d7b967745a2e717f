"""Model-free selectors: Random / Spatial / EuSpatial / Temporal /
SpatialTemporal (port of ``dal3d_tpu/selectors/geometry_selectors.py``;
reference det3d/selectors/{random,spatial,
euclidean_spatial,temporal,spatial_temporal}_selector.py)."""
from __future__ import annotations

from typing import List

import numpy as np

from ..utils.fileio import load
from . import maps
from .base_selector import BaseSelector
from .registry import SELECTORS


@SELECTORS.register_module
class RandomSelector(BaseSelector):
    """Uniform random until the cost budget is crossed
    (random_selector.py:39-66)."""

    def select_samples(self, **kwargs) -> None:
        sampled = self.get_sampled()
        left = [i for i in range(len(self.infos_origin)) if i not in set(sampled)]
        cost = self.get_cost_amount()
        costs = self.frame_costs
        selected: List[int] = []
        while left:
            idx = self.rng.choice(left)
            cost += costs[idx]
            if cost > int(self.current_budget):
                break
            selected.append(idx)
            left.remove(idx)
        self.selected_index[self.current_budget] = selected + self.round_lineage()


class _LogMixin:
    def _log_to_loc(self):
        logs = load(self.logs_file)
        return {l["logfile"]: l["location"].split("-")[-1] for l in logs}

    def _scenes(self):
        """Per-frame city/scene id; falls back to logfile name when no
        logs_file is available."""
        lfs = self.logfiles()
        try:
            l2l = self._log_to_loc()
            return np.array([l2l.get(lf, lf) for lf in lfs])
        except (FileNotFoundError, TypeError, AttributeError):
            return np.array(lfs)


@SELECTORS.register_module
class SpatialSelector(BaseSelector, _LogMixin):
    """kNN ego-position graph -> Dijkstra geodesic distances -> FPS
    (spatial_selector.py:18-138)."""

    def __init__(self, *args, k: int = 8, logs_file: str = "",
                 distance_store_file: str = "", **kwargs):
        super().__init__(*args, **kwargs)
        self.k = k
        self.logs_file = logs_file
        self.distance_store_file = distance_store_file

    def build_map(self) -> np.ndarray:
        return maps.spatial_dijkstra_map(
            self.ego_locations(), self.k, self.distance_store_file, self.logger
        )

    def select_samples(self, **kwargs) -> None:
        dm = self.build_map()
        dm = np.where(np.isfinite(dm), dm, dm[np.isfinite(dm)].max() * 2)
        sampled = self.get_sampled()
        selected = self.kcenter_on_map(dm)
        self.selected_index[self.current_budget] = self.round_lineage() + selected


@SELECTORS.register_module
class EuSpatialSelector(BaseSelector, _LogMixin):
    """Direct euclidean ego distances, cross-city margin 1e6
    (euclidean_spatial_selector.py:93-101)."""

    def __init__(self, *args, logs_file: str = "", **kwargs):
        super().__init__(*args, **kwargs)
        self.logs_file = logs_file

    def select_samples(self, **kwargs) -> None:
        dm = maps.euclidean_spatial_map(self.ego_locations(), self._scenes())
        sampled = self.get_sampled()
        selected = self.kcenter_on_map(dm)
        self.selected_index[self.current_budget] = self.round_lineage() + selected


@SELECTORS.register_module
class TemporalSelector(BaseSelector):
    """|frame index difference| within the same logfile, margin across
    (temporal_selector.py:50-104)."""

    def select_samples(self, **kwargs) -> None:
        dm, _ = maps.temporal_map(self.logfiles())
        sampled = self.get_sampled()
        selected = self.kcenter_on_map(dm)
        self.selected_index[self.current_budget] = self.round_lineage() + selected


@SELECTORS.register_module
class SpatialTemporalSelector(SpatialSelector):
    """Headline method: normalized spatial + lambda_t * temporal combination
    (spatial_temporal_selector.py:17-193)."""

    def __init__(self, *args, normalize: str = "exp", lambda_t: float = 1.0,
                 aggregate: str = "sum", **kwargs):
        super().__init__(*args, **kwargs)
        if normalize not in ("linear", "exp") or aggregate not in ("sum", "min", "max"):
            raise ValueError(f"normalize={normalize!r} / aggregate={aggregate!r}")
        self.normalize = normalize
        self.lambda_t = lambda_t
        self.aggregate = aggregate

    def select_samples(self, **kwargs) -> None:
        spatial = self.build_map()
        temporal, max_run = maps.temporal_map(self.logfiles())
        if self.normalize == "linear":
            spatial = maps.normalize_map(spatial, "linear")
            temporal = maps.normalize_map(temporal, "linear", max_value=max_run)
        else:
            spatial = maps.normalize_map(spatial, "exp")
            temporal = maps.normalize_map(temporal, "exp")
        if self.aggregate == "sum":
            dm = spatial + self.lambda_t * temporal
        elif self.aggregate == "min":
            dm = np.minimum(spatial, temporal)
        else:
            dm = np.maximum(spatial, temporal)
        dm = np.where(np.isfinite(dm), dm, 2.0)
        sampled = self.get_sampled()
        selected = self.kcenter_on_map(dm)
        self.selected_index[self.current_budget] = self.round_lineage() + selected
