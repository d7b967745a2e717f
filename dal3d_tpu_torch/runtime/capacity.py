"""Brick-capacity report (port of ``dal3d_tpu/runtime/capacity.py``).

The brick engines compact the active bricks of each level into a fixed
capacity (``backbone.banded_caps`` on the banded engine, ``brick_caps`` on
the brick engine); an overflow drops bricks (the highest (y, x, z) ones, or
the latest to appear), and the numbers degrade with no error. This report,
logged by the trainer on the first batch of a run, makes that visible:

- level 0 gives the true (uncapped) demand of the fed voxels
  (``ops/sparse_brick.py::count_active_bricks``), which can exceed its cap;
- levels 1-4 give the post-compaction count of each downsample's output,
  where a count equal to the cap means at or over capacity (the compacted
  list cannot show the overflow): flagged saturated.

The active sets depend on the coordinates alone, so levels 1-4 come from
the downsample plans (``downsample_plan``) chained from the level-0 pack,
with no convolution launched. A batch without host voxels (raw points)
gives no report, and neither does a backbone on the gather, hybrid or dense
engine (its ``voxel_caps`` are not brick capacities), as in JAX.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..ops import sparse_brick as spb
from .steps import model_inputs


@torch.no_grad()
def level_counts(backbone, vc: torch.Tensor, vv: torch.Tensor) -> List[torch.Tensor]:
    """Per-level active-brick counts [B] of ``backbone`` (an
    ``FPNSpMiddleResNetFHD``) for voxel coords [B, N, 3] (z, y, x) and
    validity [B, N]: level 0 uncapped, levels 1-4 after compaction."""
    vv = vv.bool()
    shape, bw0 = backbone.sparse_shape, backbone.widths[0]
    counts = [spb.count_active_bricks(vc, vv, shape, bw0)]
    bb = spb.from_voxels(torch.zeros(*vv.shape, 1, device=vc.device), vc, vv, shape,
                         bw=bw0, mb_cap=backbone.caps[0], spatial=backbone.spatial)
    for level in (backbone.l0, backbone.stage1, backbone.stage2, backbone.stage3):
        d = level.down
        out_lin, _, out_shape, _, _ = spb.downsample_plan(
            bb, d.kernel_size, d.stride, d.padding, d.out_bw, d.out_cap, spatial=d.spatial)
        bb = spb.BrickBatch(features=torch.zeros(*out_lin.shape, d.out_bw, device=vc.device),
                            brick_lin=out_lin,
                            vmask=torch.zeros(*out_lin.shape, d.out_bw, dtype=torch.bool,
                                              device=vc.device),
                            shape=out_shape, bw=d.out_bw)
        counts.append((out_lin < bb.num_cells).sum(-1))
    return counts


def brick_capacity_report(bundle, batch: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Per-level rows {"level", "active" (max over the batch), "cap",
    "saturated"} for one batch of host voxels, or [] for a batch without
    them or a backbone that is not on a brick engine. Saturated: the
    demand exceeds the cap (level 0) or the compacted list is full (levels
    1-4)."""
    if "voxel_features" not in batch or bundle.model.backbone.impl not in ("banded", "brick"):
        return []
    inputs = model_inputs(batch, bundle.device)
    backbone = bundle.model.backbone
    caps = backbone.caps
    rows = []
    for lvl, c in enumerate(level_counts(backbone, inputs["vc"], inputs["vv"])):
        active = int(c.max())
        cap = int(caps[lvl]) if lvl < len(caps) else -1
        rows.append({"level": lvl, "active": active, "cap": cap,
                     "saturated": active > cap if lvl == 0 else active >= cap})
    return rows


def log_capacity_report(trainer, batch) -> None:
    """The trainer's one-shot hook: log the report, a warning when a level is
    saturated. Never raises: a report must not stop a training run."""
    try:
        rows = brick_capacity_report(trainer.bundle, batch)
    except Exception as e:  # observability only
        trainer.logger.warning(f"brick capacity report failed: {e}")
        return
    if not rows:
        return
    parts = [f"L{r['level']}: {r['active']}/{r['cap']}" + (" SATURATED" if r["saturated"] else "")
             for r in rows]
    msg = "brick capacities (active/cap, first batch): " + ", ".join(parts)
    if any(r["saturated"] for r in rows):
        trainer.logger.warning(msg + " - saturated levels truncate bricks (numerics degrade "
                               "silently); raise brick_caps / banded_caps in the model config")
    else:
        trainer.logger.info(msg)
