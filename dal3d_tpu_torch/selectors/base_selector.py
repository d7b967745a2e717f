"""BaseSelector — budget/buffer/cost contract shared by all AL selectors
(port of ``dal3d_tpu/selectors/base_selector.py``).

File-format parity with det3d/selectors/base_selector.py:13-87 and with the
JAX package:
- buffer JSON: {"0": [], "<cumulative budget>": [frame indices...]},
- ``dump_file`` updates the buffer and writes the selected infos subset as
  ``<infos_origin stem>_<current_budget>.pkl`` (consumed by tools/train.py and
  by BEVFusion's create_data),
- annotation cost model: cost_f=0.12 per frame + cost_b=0.04 per box.

On top of the reference contract this base carries the scoring hooks: a
``score_fn(batch) -> {embedding, score_entropy, scores, label_preds,
det_valid}`` (the predict step) + dataloader, with npz caching of the pool
scoring pass, and the k-center helpers, which run on ``device``
(``None`` means the CUDA card and raises without one).

In a world of several ranks (``parallel``) the loader gives each rank its
rows and the score_fn gives back the global batch's outputs
(``parallel.mesh.data_parallel_predict``), so every rank holds the whole
pool's scores and runs the same selection; rank 0 alone writes the buffer,
the subset and the caches.
"""
from __future__ import annotations

import collections
import logging
import os
import random
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.distance import pairwise_l1, pairwise_l2
from ..ops.kcenter import kcenter_features, kcenter_matrix
from ..parallel.dist import master_only, write_once
from ..utils.fileio import dump, load
from .registry import SELECTORS


@SELECTORS.register_module
class BaseSelector:
    def __init__(
        self,
        budget: int,
        buffer_file: str,
        dump_file_name: Optional[str] = None,
        infos_origin: str = "",
        detector: Any = None,  # (score_fn) — kept name for config parity
        dataloader: Any = None,
        logger: Optional[logging.Logger] = None,
        pred: bool = False,
        cost_b: float = 0.04,
        cost_f: float = 0.12,
        exclude_buffer: str = "",
        device=None,
        rng=None,
        **kwargs,
    ) -> None:
        self.device = resolve_device(device)
        # source of the random first pick / RandomSelector draws: the module
        # ``random`` by default, so one ``random.seed`` gives the JAX
        # package's picks
        self.rng = random if rng is None else rng
        self.budget = budget
        self.buffer_file = buffer_file
        self.dump_file_name = buffer_file if dump_file_name is None else dump_file_name
        self.buffer = load(buffer_file)
        self.detector = detector
        self.dataloader = dataloader
        self.selected_index: Dict[str, List[int]] = {}
        self.infos_file = infos_origin
        self.infos_origin = load(infos_origin)
        self.current_budget = str(self.budget + int(self.get_max_key()))
        self.logger = logger if logger is not None else logging.getLogger(__file__)
        self.pred = pred
        self.cost_b = cost_b
        self.cost_f = cost_f
        # frames labeled OUTSIDE this selector's buffer (e.g. the partial
        # pipeline's random seed set, dataset active_buffer partial_01):
        # excluded from selection so the budget is never spent re-picking
        # already-labeled frames
        self.presampled: List[int] = []
        if exclude_buffer and os.path.exists(exclude_buffer):
            extra = load(exclude_buffer)
            self.presampled = sorted({int(i) for ids in extra.values() for i in ids})

    # ------------------------------------------------------------------
    def get_max_key(self) -> str:
        return str(max(int(k) for k in self.buffer.keys()))

    def round_lineage(self) -> List[int]:
        """This buffer's own latest round — the ids carried forward into the
        next stored round (externally-labeled frames are NOT part of the
        buffer lineage; they live in their own file)."""
        return list(self.buffer[self.get_max_key()])

    def get_sampled(self) -> List[int]:
        """Frames excluded from selection: this buffer's latest round plus
        any externally-labeled set (exclude_buffer)."""
        return sorted(set(self.buffer[self.get_max_key()]) | set(self.presampled))

    def select_samples(self, **kwargs) -> None:
        raise NotImplementedError

    @master_only
    def dump_file(self) -> None:
        """Persist this round's selection: buffer JSON + subset infos pkl.

        Both file formats are byte-compatible with the reference
        (det3d/selectors/base_selector.py:57-76) because downstream tools —
        tools/train.py's budget path rewrite and BEVFusion's create_data —
        key off them.
        """
        self.buffer.update(self.selected_index)
        dump(self.buffer, self.dump_file_name)
        self.logger.info(f"buffer -> {self.dump_file_name}")
        stem, ext = os.path.splitext(self.infos_file)
        subset_path = f"{stem}_{self.current_budget}{ext}"
        chosen = self.buffer[str(self.current_budget)]
        dump([self.infos_origin[i] for i in chosen], subset_path)
        self.logger.info(f"{len(chosen)} selected infos -> {subset_path}")

    def get_selected_samples(self):
        return self.selected_index

    def get_cost_amount(self) -> float:
        """Annotation cost already spent on the current buffer (frames x
        cost_f + boxes x cost_b, reference cost model :24-26)."""
        idx = self.buffer[self.get_max_key()]
        n_boxes = sum(len(self.infos_origin[i]["gt_names"]) for i in idx)
        return self.cost_f * len(idx) + self.cost_b * n_boxes

    # ------------------------------------------------------------------
    # shared machinery for the concrete selectors
    # ------------------------------------------------------------------
    @property
    def frame_costs(self) -> np.ndarray:
        return np.array(
            [self.cost_f + len(i["gt_names"]) * self.cost_b for i in self.infos_origin],
            np.float64,
        )

    def ego_locations(self) -> np.ndarray:
        """[N, 2] ego xy from car_from_global (reference
        spatial_selector.py:83-84: -(cal[:3,3].T @ cal[:3,:3]))."""
        locs = []
        for info in self.infos_origin:
            cal = np.asarray(info["car_from_global"])
            locs.append((-(cal[:3, 3].T @ cal[:3, :3]))[:2])
        return np.stack(locs)

    def logfiles(self) -> List[str]:
        """Per-frame logfile parsed from cam_front_path (reference :79)."""
        return [
            i["cam_front_path"].split("/")[-1].split("__")[0] for i in self.infos_origin
        ]

    def run_pool_scoring(self, cache_path: Optional[str] = None,
                         pipeline_depth: int = 2) -> Dict[str, np.ndarray]:
        """Full-pool inference: embeddings [N, C] + mean score entropy [N]
        + per-frame padded scores/labels (reference buffer_pred loops).

        The loop is pipelined: up to ``pipeline_depth`` batches are
        dispatched before the oldest result is collected, so the device works
        on a batch while the loader prepares the next and the host unpacks
        the previous. Each batch's five outputs come back in one fetch: CUDA
        tensors are packed into one buffer on the device and copied
        non-blocking into pinned memory behind an event, which the collect
        waits on. Results keep the loader's order at any depth."""
        if cache_path and os.path.exists(cache_path):
            self.logger.info(f"load pool scoring from {cache_path}")
            return dict(np.load(cache_path))
        if self.detector is None or self.dataloader is None:
            raise ValueError(
                "model-based selector needs score_fn + dataloader (or a cache file)")
        keys = ("embedding", "score_entropy", "scores", "label_preds", "det_valid")
        parts: Dict[str, list] = {k: [] for k in keys}
        pending: collections.deque = collections.deque()
        for batch in self.dataloader:
            pending.append(_start_fetch(self.detector(batch), keys))
            if len(pending) >= max(pipeline_depth, 1):
                _finish_fetch(pending.popleft(), parts)
        while pending:
            _finish_fetch(pending.popleft(), parts)
        n = len(self.infos_origin)
        result = {k: np.concatenate(parts[k])[:n] for k in keys}
        if cache_path:
            os.makedirs(os.path.dirname(os.path.abspath(cache_path)), exist_ok=True)
            write_once(lambda: np.savez(cache_path, **result))
            self.logger.info(f"saved pool scoring to {cache_path}")
        return result

    # ------------------------------------------------------------------
    def kcenter_on_map(self, distance_map: np.ndarray, restrict_to: Optional[List[int]] = None):
        """Budgeted greedy FPS over a distance map, honoring previously
        selected frames; runs on ``self.device`` (ops.kcenter). Returns the
        new selected list (reference loop at
        spatial_temporal_selector.py:157-193)."""
        N = len(self.infos_origin)
        sampled = self.get_sampled()
        dm = np.asarray(distance_map, np.float32)
        if restrict_to is not None:
            keep = np.isin(np.arange(N), list(restrict_to) + sampled)
            dm = dm.copy()
            dm[~keep] = -np.inf
            dm[:, ~keep] = -np.inf

        already = np.zeros(N, bool)
        already[sampled] = True
        if len(sampled) > 0:
            init_fps = dm[sampled].min(axis=0)
            first = int(np.argmax(np.where(already, -np.inf, init_fps)))
        else:
            first = self.rng.choice(range(N))
            init_fps = np.full(N, np.inf, np.float32)

        remaining = float(self.current_budget) - self.get_cost_amount()
        max_select = min(N - len(sampled), int(remaining / self.cost_f) + 2)
        dev = self.device
        sel, count, cost = kcenter_matrix(
            torch.from_numpy(dm).to(dev),
            torch.from_numpy(self.frame_costs.astype(np.float32)).to(dev),
            torch.tensor(np.float32(remaining), device=dev),
            torch.from_numpy(init_fps.astype(np.float32)).to(dev),
            first,
            torch.from_numpy(already).to(dev),
            max_select=max(max_select, 1),
        )
        return sel[:count].tolist()

    def kcenter_on_features(self, features: np.ndarray, metric: str = "l1",
                            restrict_to: Optional[List[int]] = None):
        """Streaming budgeted FPS directly on pooled embeddings — each pick's
        distance row is computed on the fly, so the N×N map is never
        materialized (4 N^2 bytes in f32; this needs only [N, C]). Selection
        semantics identical to
        ``kcenter_on_map(maps.feature_map(features, metric))``."""
        N = len(self.infos_origin)
        dev = self.device
        feats = torch.from_numpy(np.ascontiguousarray(features, np.float32)).to(dev)
        sampled = self.get_sampled()
        already = np.zeros(N, bool)
        already[sampled] = True
        if restrict_to is not None:
            keep = np.isin(np.arange(N), list(restrict_to) + sampled)
            already |= ~keep  # excluded-from-pool ≡ never a candidate

        if len(sampled) > 0:
            pd = pairwise_l1 if metric == "l1" else pairwise_l2
            init_fps = pd(feats[torch.as_tensor(sampled, device=dev)], feats).min(dim=0).values
            init_fps = init_fps.cpu().numpy()
            first = int(np.argmax(np.where(already, -np.inf, init_fps)))
        else:
            first = self.rng.choice(np.flatnonzero(~already).tolist() or [0])
            init_fps = np.full(N, np.inf, np.float32)

        remaining = float(self.current_budget) - self.get_cost_amount()
        max_select = min(N - len(sampled), int(remaining / self.cost_f) + 2)
        sel, count, cost = kcenter_features(
            feats,
            torch.from_numpy(self.frame_costs.astype(np.float32)).to(dev),
            torch.tensor(np.float32(remaining), device=dev),
            torch.from_numpy(init_fps.astype(np.float32)).to(dev),
            first,
            torch.from_numpy(already).to(dev),
            max_select=max(max_select, 1),
            metric=metric,
        )
        return sel[:count].tolist()

    def topk_by_score(self, scores: np.ndarray, budget: Optional[float] = None,
                      exclude: Optional[List[int]] = None) -> List[int]:
        """Greedy descending-score selection under the cost budget
        (entropy/PPAL initial pools)."""
        exclude = set(exclude or [])
        order = np.argsort(-np.asarray(scores))
        cost = self.get_cost_amount()
        limit = float(budget if budget is not None else self.current_budget)
        out: List[int] = []
        costs = self.frame_costs
        for idx in order:
            idx = int(idx)
            if idx in exclude:
                continue
            cost += costs[idx]
            if cost > limit:
                if not out:  # first pick always kept (reference behavior)
                    out.append(idx)
                break
            out.append(idx)
        return out


_ALIGN = 16  # bytes: every array of a packed fetch starts aligned for its dtype


def _start_fetch(out: Dict[str, Any], keys):
    """Begin the one fetch of a batch's outputs. CUDA tensors are viewed as
    bytes, packed into one device buffer and copied non-blocking into pinned
    host memory; an event marks the copy's end. Anything else (CPU tensors,
    numpy) passes through. bf16 comes back as f32."""
    vals = [out[k].float() if isinstance(out[k], torch.Tensor)
            and out[k].dtype == torch.bfloat16 else out[k] for k in keys]
    if not (isinstance(vals[0], torch.Tensor) and vals[0].is_cuda):
        return None, None, [v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                            for v in vals]
    metas, flat = [], []
    for v in vals:
        b = v.contiguous().reshape(-1).view(torch.uint8)
        metas.append((tuple(v.shape), v.dtype, b.numel()))
        flat += [b, b.new_zeros(-b.numel() % _ALIGN)]
    packed = torch.cat(flat)
    host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return done, host, metas


def _finish_fetch(fetch, parts: Dict[str, list]) -> None:
    """Wait for a batch's copy and append its arrays (``parts`` is keyed in
    the order the fetch was started with)."""
    done, host, metas = fetch
    if done is None:
        arrays = metas
    else:
        done.synchronize()
        arrays, off = [], 0
        for shape, dtype, nbytes in metas:
            arrays.append(host[off:off + nbytes].view(dtype).reshape(shape).numpy())
            off += nbytes + (-nbytes % _ALIGN)
    for k, a in zip(parts, arrays):
        parts[k].append(a)
