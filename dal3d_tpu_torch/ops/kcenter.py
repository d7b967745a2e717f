"""Greedy budget-capped farthest-point (k-center) selection (port of
``dal3d_tpu/ops/kcenter.py``).

The shared selection loop of every diversity selector: keep
``fps = min(fps, D[last])``, pick the first argmax, add the frame's
annotation cost, stop when the budget is crossed (the crossing pick is not
kept). Same semantics as the JAX ``lax.while_loop``:
- the first pick's cost is always paid,
- ``already`` and every pick are masked to -inf, ties go to the lowest index,
- the loop stops on ``new_cost > budget``, on an exhausted pool (every
  candidate masked) or at ``max_select``,
- fps, costs and the running cost are f32 on the tensors' device: the stop
  test decides the last pick, so the cost accumulates in f32 as in JAX.

Here the loop is a Python loop with one scalar read per pick. -inf masks go
through ``minimum`` / ``argmax`` only, never through the distance kernels.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from .distance import pairwise_l1, pairwise_l2

NEG = float("-inf")


def _greedy(row: Callable[[int], torch.Tensor], frame_costs, budget, init_fps, first_idx,
            already, max_select: int) -> Tuple[torch.Tensor, int, torch.Tensor]:
    dev = init_fps.device
    costs = torch.as_tensor(frame_costs, dtype=torch.float32, device=dev)
    budget = torch.as_tensor(budget, dtype=torch.float32, device=dev)
    already = torch.as_tensor(already, dtype=torch.bool, device=dev)
    first = int(first_idx)
    # min(-inf, d) stays -inf, so the masks are applied once
    fps = torch.where(already, NEG, init_fps.to(torch.float32))
    fps[first] = NEG
    sel = [first]
    cost = costs[first].clone()
    last = first
    stop = bool(cost > budget)
    while not stop and len(sel) < max_select:
        fps = torch.minimum(fps, row(last))
        fps[last] = NEG
        nxt = torch.argmax(fps)  # first occurrence of the maximum
        new_cost = cost + costs[nxt]
        ok = (new_cost <= budget) & torch.isfinite(fps[nxt])
        nxt_i, ok_i = torch.stack((nxt, ok.to(nxt.dtype))).tolist()  # the one read
        if not ok_i:
            break
        sel.append(nxt_i)
        cost, last = new_cost, nxt_i
    out = torch.full((max_select,), -1, dtype=torch.int32, device=dev)
    out[:len(sel)] = torch.tensor(sel, dtype=torch.int32)
    return out, len(sel), cost


def kcenter_matrix(dist: torch.Tensor, frame_costs, budget, init_fps: torch.Tensor,
                   first_idx, already, max_select: int):
    """dist [N, N] f32, frame_costs [N] (cost_f + cost_b * boxes), budget
    (remaining), init_fps [N] (inf if nothing is selected yet), first_idx
    (first pick), already [N] bool (excluded). Returns (selected
    [max_select] int32 padded with -1, count, cost)."""
    return _greedy(lambda i: dist[i], frame_costs, budget, init_fps, first_idx, already,
                   max_select)


def kcenter_features(features: torch.Tensor, frame_costs, budget, init_fps: torch.Tensor,
                     first_idx, already, max_select: int, metric: str = "l2"):
    """Streaming variant: each pick's distance row comes from
    ``ops.distance`` (x = features[last:last+1]), so on the card every pick
    launches the L1 or the L2 kernel and no [N, N] map exists."""
    pd = pairwise_l1 if metric == "l1" else pairwise_l2
    return _greedy(lambda i: pd(features[i:i + 1], features)[0], frame_costs, budget,
                   init_fps, first_idx, already, max_select)


def kcenter_numpy(dist, frame_costs, budget, init_fps, first_idx, already):
    """Host oracle replicating the reference loop verbatim (for tests)."""
    fps = np.where(already, -np.inf, init_fps).astype(np.float64)
    sel = [int(first_idx)]
    cost = float(frame_costs[first_idx])
    fps[first_idx] = -np.inf
    last = int(first_idx)
    while True:
        fps = np.minimum(fps, dist[last])
        fps[np.asarray(already)] = -np.inf
        fps[last] = -np.inf
        nxt = int(np.argmax(fps))
        if not np.isfinite(fps[nxt]):
            break
        cost_next = cost + float(frame_costs[nxt])
        if cost_next > budget:
            break
        sel.append(nxt)
        cost = cost_next
        last = nxt
    return sel, cost
