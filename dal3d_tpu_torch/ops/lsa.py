"""Linear sum assignment (Jonker-Volgenant shortest augmenting path) for
TransFusion's Hungarian matching (port of ``dal3d_tpu/ops/lsa.py``).

    col4row[b, g] = the column (proposal) given to row (GT box) g of cost[b],
                    at the least total cost; -1 for the G - P rows left
                    without one when G > P

The plain version is JAX's algorithm written out in f32: rows visited in
order, 1-indexed ``p`` / ``way`` with column 0 as the virtual source, the
finite stand-in ``_BIG`` for infinity, the ``it <= i + 1`` guard of each
row's search, and the transposed problem when G > P. Its loop is data
dependent, so on the card every augmenting step of the plain version waits
for the host; the kernel (``csrc/lsa.cu``) runs the whole solve of one
batch element in one block, with the same arithmetic in the same order, so
that kernel and plain version give the same ``col4row``.

Padded rows (constant cost) are solved like any other, as JAX does: a
constant row cannot change the optimal cost of the others, but in f32 it can
move a tie, so skipping them could give another ``col4row``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_BIG = 1e30  # finite stand-in for +inf (keeps f32 arithmetic well-defined)
_P, _I = ctypes.c_void_p, ctypes.c_int
_LSA_ARGS = [_P, _P, _I, _I, _I]


def _solve_plain(cost: torch.Tensor) -> torch.Tensor:
    """col4row [G] int32 of one problem cost [G, P] f32 with G <= P, by
    JAX's loop (``dal3d_tpu/ops/lsa.py``)."""
    G, P = cost.shape
    dev = cost.device
    big = torch.tensor([_BIG], dtype=torch.float32, device=dev)
    u = torch.zeros(G + 1, dtype=torch.float32, device=dev)
    v = torch.zeros(P + 1, dtype=torch.float32, device=dev)
    p = torch.zeros(P + 1, dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(G):
        p[0] = i + 1
        minv = torch.full((P + 1,), _BIG, dtype=torch.float32, device=dev)
        way = torch.zeros(P + 1, dtype=torch.int64, device=dev)
        used = torch.zeros(P + 1, dtype=torch.bool, device=dev)
        j0, it = 0, 0
        while int(p[j0]) != 0 and it <= i + 1:
            used[j0] = True
            i0 = int(p[j0])  # 1-indexed row whose edges are relaxed
            cur = torch.cat([big, cost[i0 - 1] - u[i0] - v[1:]])
            upd = ~used & (cur < minv)
            minv = torch.where(upd, cur, minv)
            way = torch.where(upd, j0, way)
            masked = torch.where(used, big, minv)
            j1 = int(torch.argmin(masked))  # the first index of the minimum
            delta = masked[j1]
            u = u.index_add(0, torch.where(used, p, 0), torch.where(used, delta, zero))
            v = torch.where(used, v - delta, v)
            minv = torch.where(used, minv, minv - delta)
            j0, it = j1, it + 1
            linear_sum_assignment_plain.relax_steps += 1
        while j0 != 0:  # augment: walk the predecessor columns back to the source
            j1 = int(way[j0])
            p[j0] = p[j1]
            j0 = j1
    rows = p[1:]
    col4row = torch.zeros(G + 1, dtype=torch.int32, device=dev)
    col4row[torch.where(rows > 0, rows - 1, G)] = torch.arange(P, dtype=torch.int32, device=dev)
    return col4row[:G]


def linear_sum_assignment_plain(cost: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: cost [B, G, P] -> col4row [B, G] int32, one
    problem after another (G > P: the transposed problem, inverted)."""
    B, G, P = cost.shape
    if G > P:
        row4col = linear_sum_assignment_plain(cost.transpose(1, 2))
        return _invert(row4col, G)
    cost = cost.float()
    if B == 0 or G == 0:
        return torch.zeros(B, G, dtype=torch.int32, device=cost.device)
    return torch.stack([_solve_plain(cost[b]) for b in range(B)])


# relax / argmin steps the plain version has taken (each an O(P) pass): the
# work of a solve, for the kernel's bound
linear_sum_assignment_plain.relax_steps = 0


def _invert(row4col: torch.Tensor, G: int) -> torch.Tensor:
    """row4col [B, P] (every column matched) -> col4row [B, G], -1 for the
    rows no column took."""
    B, P = row4col.shape
    col4row = torch.full((B, G), -1, dtype=torch.int32, device=row4col.device)
    col4row.scatter_(1, row4col.long(), torch.arange(P, dtype=torch.int32,
                                                     device=row4col.device).expand(B, P))
    return col4row


def linear_sum_assignment(cost: torch.Tensor) -> torch.Tensor:
    """Min-cost assignment of each row to a distinct column: cost [B, G, P]
    (or [G, P]) -> col4row [B, G] (or [G]) int32, -1 where G > P leaves a
    row unmatched.

    CPU tensors take the plain version. CUDA tensors launch
    ``csrc/lsa.cu`` (one block per problem) or raise. The cost is not
    differentiated (the caller's cost is a stopped gradient).
    ``linear_sum_assignment.launches`` counts kernel launches."""
    if cost.dim() == 2:
        return linear_sum_assignment(cost[None])[0]
    if cost.dim() != 3:
        raise ValueError(f"linear_sum_assignment: cost {tuple(cost.shape)}, expected [B, G, P]")
    dev = cost.device
    if dev.type == "cpu":
        return linear_sum_assignment_plain(cost.detach())
    if dev.type != "cuda":
        raise ValueError(f"linear_sum_assignment: unsupported device {dev}")
    B, G, P = cost.shape
    if G > P:
        return _invert(linear_sum_assignment(cost.transpose(1, 2)), G)
    cost = cost.detach().float().contiguous()
    col4row = torch.empty(B, G, dtype=torch.int32, device=dev)
    if B * G == 0:
        return col4row
    _build.function("lsa", "lsa_f32", _LSA_ARGS, "linear_sum_assignment")(
        dev, cost.data_ptr(), col4row.data_ptr(), B, G, P)
    linear_sum_assignment.launches += 1
    return col4row


linear_sum_assignment.launches = 0
