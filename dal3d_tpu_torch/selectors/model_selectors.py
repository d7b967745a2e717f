"""Model-based selectors: Feature / Entropy / Badge / UWE / PPAL / Cald
(port of ``dal3d_tpu/selectors/model_selectors.py``; reference
det3d/selectors/{feature,entropy,badge,uwe,ppal}_selector.py).

All consume the scoring pass (BaseSelector.run_pool_scoring — the
reference's ``estimate=True`` buffer_pred loops): pooled neck embeddings
[N, C], per-frame mean binary score entropy [N], padded per-detection
scores/labels.
"""
from __future__ import annotations

import os
from typing import List, Optional, Union

import numpy as np

from ..utils.fileio import load
from . import maps
from .base_selector import BaseSelector
from .registry import SELECTORS

# above this pool size the N×N feature-distance map is not materialized
# (4 N^2 bytes in f32); the streaming kcenter_features loop is used
STREAMING_POOL_THRESHOLD = 20000


class _ModelSelectorBase(BaseSelector):
    def __init__(self, *args, pred_store_file: Optional[str] = None,
                 distance_type: str = "l2_ref",
                 distance_store_file: Optional[str] = None,
                 streaming: Union[bool, str] = "auto", **kwargs):
        super().__init__(*args, **kwargs)
        self.pred_store_file = pred_store_file
        self.distance_type = distance_type
        self.distance_store_file = distance_store_file
        self.streaming = streaming

    def scoring(self):
        return self.run_pool_scoring(self.pred_store_file)

    def kcenter_embed(self, features: np.ndarray,
                      restrict_to: Optional[List[int]] = None) -> List[int]:
        """Budgeted FPS over embedding distances — materialized map for small
        pools (cacheable via distance_store_file), streaming rows for large
        ones (``streaming=True`` / ``"auto"`` beyond STREAMING_POOL_THRESHOLD)."""
        metric = "l1" if self.distance_type in ("l1", "l2_ref") else "l2"
        cached = bool(self.distance_store_file) and os.path.exists(self.distance_store_file)
        use_stream = self.streaming is True or (
            self.streaming == "auto" and len(features) > STREAMING_POOL_THRESHOLD
            and not cached
        )
        if use_stream:
            self.logger.info(
                f"streaming k-center over {len(features)} frames (no N×N map)")
            return self.kcenter_on_features(features, metric, restrict_to=restrict_to)
        dm = maps.feature_map(features, self.distance_type, self.distance_store_file,
                              device=self.device)
        return self.kcenter_on_map(dm, restrict_to=restrict_to)


@SELECTORS.register_module
class FeatureSelector(_ModelSelectorBase):
    """FPS over pairwise pooled-embedding distances
    (feature_selector.py:17-172)."""

    def select_samples(self, **kwargs) -> None:
        s = self.scoring()
        sampled = self.get_sampled()
        selected = self.kcenter_embed(s["embedding"])
        self.selected_index[self.current_budget] = self.round_lineage() + selected


@SELECTORS.register_module
class EntropySelector(_ModelSelectorBase):
    """Pure top-K by mean detection-score entropy under the cost budget —
    the uncertainty baseline (entropy_selector.py:14-147)."""

    def select_samples(self, **kwargs) -> None:
        s = self.scoring()
        sampled = self.get_sampled()
        ent = np.asarray(s["score_entropy"]).copy()
        selected = self.topk_by_score(ent, exclude=sampled)
        self.selected_index[self.current_budget] = selected + self.round_lineage()


@SELECTORS.register_module
class BadgeSelector(_ModelSelectorBase):
    """BADGE-style: embeddings scaled by mean entropy, then FPS
    (badge_selector.py:17-178, weighting at :76-79)."""

    def select_samples(self, **kwargs) -> None:
        s = self.scoring()
        weighted = s["embedding"] * s["score_entropy"][:, None]
        sampled = self.get_sampled()
        selected = self.kcenter_embed(weighted)
        self.selected_index[self.current_budget] = self.round_lineage() + selected


@SELECTORS.register_module
class UWESelector(_ModelSelectorBase):
    """Uncertainty-weighted embeddings: min-max-normalized entropy scales the
    embeddings before FPS (uwe_selector.py:17-197, :70-98)."""

    def select_samples(self, **kwargs) -> None:
        s = self.scoring()
        ent = np.asarray(s["score_entropy"])
        denom = max(ent.max() - ent.min(), 1e-12)
        norm = (ent - ent.min()) / denom
        weighted = s["embedding"] * norm[:, None]
        sampled = self.get_sampled()
        selected = self.kcenter_embed(weighted)
        self.selected_index[self.current_budget] = self.round_lineage() + selected


@SELECTORS.register_module
class PPALSelector(_ModelSelectorBase):
    """Difficulty-weighted entropy builds a delta*budget initial pool, then
    FPS restricted to that pool (ppal_selector.py:18-239): rows/cols outside
    pool+sampled masked to -inf before the greedy loop."""

    def __init__(self, *args, diff_file: str = "", delta: float = 1.5, **kwargs):
        super().__init__(*args, **kwargs)
        self.diff_file = diff_file
        self.delta = delta

    def weighted_entropy(self, s) -> np.ndarray:
        """Sum over detections of entropy * per-class difficulty weight
        (ppal buffer_pred :86-99)."""
        class_weight = load(self.diff_file)
        names = list(class_weight.keys())
        # label ids follow the flat task class order
        sc = np.clip(np.asarray(s["scores"]), 1e-6, 1 - 1e-6)
        ent = -(sc * np.log(sc) + (1 - sc) * np.log(1 - sc))
        labels = np.asarray(s["label_preds"])
        valid = np.asarray(s["det_valid"]).astype(bool)
        w = np.asarray([class_weight[n] for n in names], np.float64)
        det_w = w[np.clip(labels, 0, len(names) - 1)]
        return (ent * det_w * valid).sum(axis=1)

    def select_samples(self, **kwargs) -> None:
        s = self.scoring()
        sampled = self.get_sampled()
        went = self.weighted_entropy(s)
        pool_budget = float(self.current_budget) + self.budget * (self.delta - 1)
        initial_pool = self.topk_by_score(went, budget=pool_budget, exclude=sampled)
        selected = self.kcenter_embed(s["embedding"], restrict_to=initial_pool)
        self.selected_index[self.current_budget] = selected + self.round_lineage()


@SELECTORS.register_module
class CaldSelector(BaseSelector):
    """CALD: consumes the precomputed consistency ranking
    (cald_ent_sorted_idx.json from tools/cald_ent.py) + JS-divergence dict;
    two-stage: 1.5x-budget consistency pool re-ranked by JS divergence
    (cald_selector.py:18-137)."""

    def __init__(self, *args, sorted_idx_file: str = "", jsdiv_file: str = "", **kwargs):
        super().__init__(*args, **kwargs)
        self.sorted_idx_file = sorted_idx_file
        self.jsdiv_file = jsdiv_file

    def select_samples(self, **kwargs) -> None:
        sampled = self.get_sampled()
        ranking: List[int] = [i for i in load(self.sorted_idx_file) if i not in set(sampled)]
        costs = self.frame_costs

        # stage 1: consistency pool until budget * 1.5
        cost = self.get_cost_amount()
        pool: List[int] = []
        limit1 = int(self.current_budget) + self.budget * 0.5
        for idx in ranking:
            cost += costs[idx]
            if cost > limit1 and pool:
                break
            pool.append(idx)

        # stage 2: walk the global JS-divergence ranking, keep pool members
        idx_to_jsdiv = load(self.jsdiv_file)
        js_ranking = [k for k, _ in sorted(idx_to_jsdiv.items(), key=lambda x: x[1], reverse=True)]
        pool_set = set(pool)
        cost = self.get_cost_amount()
        selected: List[int] = []
        for idx in js_ranking:
            idx = int(idx)
            if idx not in pool_set:
                continue
            cost += costs[idx]
            if cost > int(self.current_budget) and selected:
                break
            selected.append(idx)
        self.selected_index[self.current_budget] = selected + self.round_lineage()
