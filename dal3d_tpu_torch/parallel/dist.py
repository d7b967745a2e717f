"""Process-group helpers (port of ``dal3d_tpu/parallel/dist.py``).

The rank and the world are those of ``torch.distributed``'s default process
group; without one the process is rank 0 of a world of 1, and every helper
here is a passthrough that runs no collective. ``init_dist`` starts the
group from the variables a launcher such as ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); the
port reads no variable of its own.
"""
from __future__ import annotations

import contextlib
import datetime
import functools
import os
from typing import Any, Callable, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

# every group's collectives fail after this long instead of hanging, so a
# rank that skips a collective another rank entered ends the run quickly
GROUP_TIMEOUT = datetime.timedelta(seconds=120)


def get_dist_info() -> Tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def master_only(func):
    """Run ``func`` on rank 0 only; the other ranks get None."""
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if get_dist_info()[0] == 0:
            return func(*args, **kwargs)

    return wrapper


def synchronize() -> None:
    """A barrier over every rank; nothing in a world of 1."""
    if get_dist_info()[1] > 1:
        dist.barrier()


def write_once(write: Callable[[], Any]) -> None:
    """Call ``write()`` on rank 0 alone, once every rank has arrived (so that
    no rank still checks whether the file exists) and before any leaves (so
    that every rank then finds it whole). ``write()`` itself in a world of
    1."""
    rank, world = get_dist_info()
    if world == 1:
        write()
        return
    dist.barrier()
    if rank == 0:
        write()
    dist.barrier()


def all_gather_objects(obj: Any) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order; ``[obj]`` in a world
    of 1."""
    world = get_dist_info()[1]
    if world == 1:
        return [obj]
    out: List[Any] = [None] * world
    dist.all_gather_object(out, obj)
    return out


@contextlib.contextmanager
def same_numpy_draws():
    """Inside: every rank draws from rank 0's state of numpy's global
    generator, so that what a dataset draws while it is built (the CBGS
    resampling) is the same on every rank, with or without a seed. On the
    way out, rank r > 0 reseeds from a draw of that shared state plus r, so
    that the ranks' pipeline draws (augmentation, sweeps) are streams of
    their own; rank 0 goes on from the shared state, as one process would.
    Nothing happens in a world of 1."""
    rank, world = get_dist_info()
    if world > 1:
        state = [np.random.get_state() if rank == 0 else None]
        dist.broadcast_object_list(state, src=0)
        np.random.set_state(state[0])
    yield
    if world > 1 and rank > 0:
        np.random.seed(int(np.random.randint(2 ** 31 - world)) + rank)


def init_dist(backend: str = "nccl") -> Tuple[int, int]:
    """Start the default process group from the launcher's variables and
    return (rank, world size).

    Nothing happens when ``WORLD_SIZE`` is unset (a plain single process)
    or when a group already exists (a caller that started its own, such as
    a test's ``gloo`` world, keeps it). ``backend`` is the caller's choice:
    ``"nccl"`` puts each rank on the card ``LOCAL_RANK`` before the group
    starts (one rank a card); ``"gloo"`` leaves the devices alone (the CPU,
    or several ranks on one card). ``WORLD_SIZE=1`` starts a group of one,
    which runs no collective."""
    if "WORLD_SIZE" not in os.environ or (dist.is_available() and dist.is_initialized()):
        return get_dist_info()
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = None
    if backend == "nccl":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT, device_id=device)
    return rank, world


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks with its gradient: every rank's loss depends on
    the sum, so the gradient of a rank's share is the sum over the ranks of
    the sum's gradient."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiable; ``x`` itself in a world
    of 1."""
    if get_dist_info()[1] == 1:
        return x
    return _AllReduceSum.apply(x)


def shared_normaliser(count: torch.Tensor, floor=1) -> torch.Tensor:
    """The divisor that makes a rank's loss sum its share of the global
    batch's normalised loss: ``clamp(count summed over the ranks, floor) /
    world``. Divided by it, a rank's sum is ``world`` times its part of the
    global loss, so the mean over the ranks (the gradient reduction) is the
    global loss. ``clamp(count, floor)`` in a world of 1. ``count`` is a
    detached count (matched boxes, weights)."""
    world = get_dist_info()[1]
    if world == 1:
        return torch.clamp(count, min=floor)
    total = count.detach().clone()
    dist.all_reduce(total)
    return torch.clamp(total, min=floor) / world
