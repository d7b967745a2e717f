"""Frame-distance map construction (spatial / temporal / feature), port of
``dal3d_tpu/selectors/maps.py``. The spatial and temporal maps are built on
the host with numpy / scipy as there; ``feature_map`` goes through
``ops.distance`` on the selector's device, so on the card it launches the
pairwise-distance kernels.

Parity with the reference map builders:
- spatial geodesic: kNN graph (k=8) over ego positions -> Dijkstra shortest
  paths (spatial_selector.py:85-117), cached as .npy,
- euclidean spatial with cross-city margin (euclidean_spatial_selector.py:
  93-101),
- temporal: |frame index difference| within a logfile, margin 1e6 across
  (temporal_selector.py:50-104 / spatial_temporal_selector.py:109-134),
- feature: pairwise distances of pooled embeddings — the reference's "p=2"
  branch computes sqrt elementwise before summing (feature_selector.py:104),
  which equals L1; metric "l2_ref" replicates that quirk, "l2" is true
  Euclidean.
- normalization: "linear" (/max) or "exp" (1 - exp(-d))
  (spatial_temporal_selector.py:138-146).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.distance import pairwise_l1, pairwise_l2
from ..parallel.dist import write_once


def spatial_dijkstra_map(
    locations: np.ndarray, k: int = 8, cache_file: Optional[str] = None, logger=None
) -> np.ndarray:
    if cache_file and os.path.exists(cache_file):
        return np.load(cache_file)
    from scipy import sparse, spatial

    n = locations.shape[0]
    sparse_distances = np.zeros([n, n])
    tree = spatial.cKDTree(locations)
    knn_distances, knn_ids = tree.query(locations, min(k + 1, n))
    for self_id, (nd, ni) in enumerate(zip(knn_distances, knn_ids)):
        sparse_distances[self_id, ni] = nd
        sparse_distances[ni, self_id] = nd
    dist = sparse.csgraph.shortest_path(sparse_distances, directed=False, method="D")
    if cache_file:
        os.makedirs(os.path.dirname(os.path.abspath(cache_file)), exist_ok=True)
        write_once(lambda: np.save(cache_file, dist))
    return dist


def euclidean_spatial_map(
    locations: np.ndarray, frame_to_scene: np.ndarray, margin: float = 1e6
) -> np.ndarray:
    diff = locations[:, None, :] - locations[None, :, :]
    dist = np.sqrt((diff**2).sum(-1))
    same = frame_to_scene[:, None] == frame_to_scene[None, :]
    return np.where(same, dist, margin)


def logfile_groups(logfiles: List[str]) -> Dict[str, List[int]]:
    """Consecutive-run grouping (reference builds groups by scanning for
    logfile changes, spatial_temporal_selector.py:114-129)."""
    groups: Dict[str, List[int]] = {}
    flag = 0
    prev = None
    for i, lf in enumerate(logfiles):
        if lf != prev:
            if prev is not None:
                flag += 1
            prev = lf
            groups[str(flag)] = []
        groups[str(flag)].append(i)
    return groups


def temporal_map(logfiles: List[str], margin: float = 1e6) -> Tuple[np.ndarray, float]:
    n = len(logfiles)
    out = np.full((n, n), margin)
    groups = logfile_groups(logfiles)
    max_run = max((len(v) for v in groups.values()), default=1)
    for frames in groups.values():
        f = np.asarray(frames)
        out[np.ix_(f, f)] = np.abs(f[None, :] - f[:, None])
    return out, float(max_run)


def feature_map(features: np.ndarray, metric: str = "l2_ref",
                cache_file: Optional[str] = None, device=None) -> np.ndarray:
    """[N, N] distances of the embeddings, computed on ``device`` (``None``
    means the CUDA card, as for every entry point of the port)."""
    if cache_file and os.path.exists(cache_file):
        return np.load(cache_file)
    f = torch.from_numpy(np.ascontiguousarray(features, np.float32)).to(resolve_device(device))
    if metric in ("l1", "l2_ref"):  # reference p=2 == elementwise sqrt(sq) == L1
        d = pairwise_l1(f, f)
    elif metric in ("l2", "euclidean"):
        d = pairwise_l2(f, f)
    else:
        raise ValueError(metric)
    d = d.cpu().numpy()
    if cache_file:
        os.makedirs(os.path.dirname(os.path.abspath(cache_file)), exist_ok=True)
        write_once(lambda: np.save(cache_file, d))
    return d


def normalize_map(d: np.ndarray, mode: str = "exp", max_value: Optional[float] = None) -> np.ndarray:
    if mode == "linear":
        mv = max_value if max_value is not None else d[np.isfinite(d)].max()
        return d / mv
    if mode == "exp":
        return 1 - np.exp(-d)
    raise ValueError(mode)
