"""Data parallelism over the ranks of a process group (port of
``dal3d_tpu/parallel/mesh.py``).

JAX runs one program over a device mesh: the batch is sharded over the
``data`` axis, the parameters are replicated, and XLA inserts the gradient
and batch-statistic reductions. The port runs one process a rank (``torchrun
--nproc_per_node N``) on the same contract: every rank holds the whole
model, draws the same global batches and loads its rows of each
(``data/loader.py``), and every statistic and normaliser is taken over the
global batch:

- the train-mode batch norms all-reduce their statistics inside the forward
  (``models/layers.py``, ``ops/dense_sparse.py::masked_mean_var``);
- the loss normalisers that count over the batch are summed over the ranks
  (``dist.shared_normaliser``);
- the gradients are all-reduced and averaged before the optimizer's clip
  (``all_reduce_gradients``), and the logs are reduced (``reduce_logs``);
- a predict step gathers its outputs, so every rank holds the global
  batch's (``data_parallel_predict``).

The gradient reduction is an explicit all-reduce of every parameter's
gradient, not ``DistributedDataParallel``: the model keeps its names (no
``module.`` prefix in checkpoints), a parameter that a config leaves
without a gradient reduces as zeros on every rank (no
``find_unused_parameters``), and a world of 1 runs no collective, so it
gives the single process's bits.

JAX's model axis (``make_mesh``'s ``n_model``, ``bev_constraint``) waits
for ROADMAP A11.b.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .dist import get_dist_info


def global_batch_size(batch_size: Optional[int], cfg, world: int) -> int:
    """The global batch of a CLI: ``--batch_size`` when given, else the
    config's ``samples_per_gpu`` x the world, as JAX's CLIs take
    ``samples_per_gpu`` x the devices. It must divide by the world."""
    batch_size = batch_size or cfg["data"].get("samples_per_gpu", 2) * world
    if batch_size % world:
        raise ValueError(f"--batch_size {batch_size} names the global batch and must divide "
                         f"by the {world} ranks of the world")
    return batch_size


def shard_batch(batch: Dict[str, Any], rank: int, world: int) -> Dict[str, Any]:
    """Rank ``rank``'s rows of a global batch of B = world x b frames: rows
    [rank b, (rank + 1) b) of every array (the per-task lists element by
    element) and of every per-frame list (``metadata``)."""
    def rows(v):
        if isinstance(v, (np.ndarray, torch.Tensor)):
            b = v.shape[0] // world
            return v[rank * b:(rank + 1) * b]
        if isinstance(v, list) and v and isinstance(v[0], (np.ndarray, torch.Tensor)):
            return [rows(x) for x in v]
        if isinstance(v, list):
            b = len(v) // world
            return v[rank * b:(rank + 1) * b]
        return v

    return {k: rows(v) for k, v in batch.items()}


def gather_rows(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every rank's fixed-shape outputs [b, ...] -> the global batch's [W b,
    ...] in rank order (frame order), on every rank. The tensors travel as
    bytes in one all-gather a call."""
    world = get_dist_info()[1]
    keys = list(out)
    flat, metas = [], []
    for k in keys:
        v = out[k].contiguous()
        b = v.reshape(-1).view(torch.uint8)
        metas.append((tuple(v.shape), v.dtype, b.numel()))
        flat.append(b)
    packed = torch.cat(flat)
    parts = [torch.empty_like(packed) for _ in range(world)]
    dist.all_gather(parts, packed)
    gathered = {}
    off = 0
    for k, (shape, dtype, n) in zip(keys, metas):
        gathered[k] = torch.cat([p[off:off + n].view(dtype).reshape(shape) for p in parts])
        off += n
    return gathered


def data_parallel_predict(predict: Callable[[Dict], Dict[str, torch.Tensor]]):
    """Wrap a predict step that a rank calls on its rows of a global batch:
    the wrapped step returns the global batch's outputs, gathered in frame
    order, on every rank (as a JAX global array is whole on every host).
    The step itself in a world of 1."""
    if get_dist_info()[1] == 1:
        return predict

    def wrapped(batch: Dict) -> Dict[str, torch.Tensor]:
        return gather_rows(predict(batch))

    return wrapped


def sharded_eval_predict(bundle, logger=None, what: str = "eval"):
    """The predict step of the eval and pool-scoring CLIs (``tools/test.py``,
    ``tools/dist_test.py``, ``tools/active_select.py``): the bundle's
    predict step under ``data_parallel_predict``."""
    from ..runtime.steps import make_predict_step

    world = get_dist_info()[1]
    if world > 1 and logger is not None:
        logger.info(f"{what} sharded over {world} ranks")
    return data_parallel_predict(make_predict_step(bundle))


def all_reduce_gradients(params: Iterable[torch.Tensor]) -> None:
    """Average every parameter's ``.grad`` over the ranks, in place (a
    missing gradient counts as zeros and is set), in one all-reduce.
    Nothing in a world of 1."""
    world = get_dist_info()[1]
    if world == 1:
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat)
    flat.div_(world)
    off = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[off:off + n].view_as(p.grad))
        off += n


def reduce_logs(logs: Dict[str, torch.Tensor], sums: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """A train step's 0-d logs over the global batch: the mean over the
    ranks, the sum for the counts named in ``sums``, in one all-reduce.
    The logs themselves in a world of 1."""
    world = get_dist_info()[1]
    if world == 1:
        return logs
    keys = list(logs)
    vec = torch.stack([logs[k].detach().to(torch.float64) for k in keys])
    dist.all_reduce(vec)
    return {k: vec[i] if k in sums else vec[i] / world for i, k in enumerate(keys)}
