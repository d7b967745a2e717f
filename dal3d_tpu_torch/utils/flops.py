"""Forward FLOP count of the port's models (``tools/get_flops.py`` and the
FPS harness's report).

JAX's ``tools/get_flops.py`` reads XLA's ``cost_analysis()`` of the jitted
forward: the cost of fixed, capped shapes, elementwise ops included. The
port counts the work the forward's inputs ask for, through forward hooks on
the modules that run it:

- dense convs, transposed convs and linears, 2 x the multiply-adds of their
  shapes (``nn.Conv*d``, ``nn.ConvTranspose*d``, ``nn.Linear``, the RPN's
  functional ``ConvBN``, the multi-group head's 1x1 ``TaskHead``, and the
  two products of TransFusion's attention);
- sparse convs (``SubMConv``, ``SparseConvDown`` on every engine), 2 x hits
  x Cin x Cout, where the hits are the (input, output, tap) triples of the
  conv: every active output site against every active input site under its
  kernel. Each engine's conv reports the triples of its own active sets, so
  the caps of an engine show in its count; the dense engine computes every
  cell of its grids, and its count is the same triples of its occupancy.

Batch norms, activations, the voxelizer and the post-processing are not
counted. A library FLOP counter would see none of the port's hand-written
kernels, so none is used.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass
class FlopCount:
    """Forward FLOPs split into dense and sparse work, per top-level stage
    (the model's child modules: ``backbone``, ``neck``, ``head``, ...), and
    one row per sparse conv (name, hits, Cin, Cout)."""

    dense: int = 0
    sparse: int = 0
    hits: int = 0
    stages: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    sparse_convs: List[Tuple[str, int, int, int]] = dataclasses.field(default_factory=list)

    @property
    def total(self) -> int:
        return self.dense + self.sparse


def active_sites(x) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """The active sites of a sparse conv's input or output, [N, 4] int64
    (b, z, y, x), and the grid (D, H, W): the batch's own ``active_sites()``,
    or the occupancy of the ``(dense, occupancy)`` pair that the layers take
    on the dense engine."""
    if isinstance(x, tuple):
        occ = x[1]
        return torch.nonzero(occ > 0), tuple(int(d) for d in occ.shape[1:])
    return x.active_sites(), tuple(x.shape)


def _triple(v) -> Tuple[int, int, int]:
    return tuple(int(a) for a in v) if isinstance(v, (tuple, list)) else (int(v),) * 3


def conv_hits(in_sites: torch.Tensor, shape, out_sites: torch.Tensor, kernel_size,
              stride=1, padding=0) -> int:
    """(input, output, tap) triples of a conv: for every output site o and
    tap k, whether the input site s * o - p + k is active. ``in_sites`` /
    ``out_sites`` [N, 4] (b, z, y, x); ``shape`` the input grid (D, H, W)."""
    dims = torch.tensor(shape, device=in_sites.device)
    D, H, W = shape

    def key(b, zyx):
        return ((b * D + zyx[..., 0]) * H + zyx[..., 1]) * W + zyx[..., 2]

    keys = torch.sort(key(in_sites[:, 0], in_sites[:, 1:])).values
    taps = torch.tensor(np.stack(np.meshgrid(*(np.arange(k) for k in _triple(kernel_size)),
                                             indexing="ij"), -1).reshape(-1, 3),
                        device=in_sites.device)
    st = torch.tensor(_triple(stride), device=in_sites.device)
    pad = torch.tensor(_triple(padding), device=in_sites.device)
    src = out_sites[:, None, 1:] * st - pad + taps[None]  # [M, K, 3]
    inb = ((src >= 0) & (src < dims)).all(-1)
    if keys.numel() == 0:
        return 0
    want = torch.where(inb, key(out_sites[:, :1], src), torch.full_like(inb, -1, dtype=torch.long))
    pos = torch.clamp(torch.searchsorted(keys, want), max=keys.numel() - 1)
    return int((inb & (keys[pos] == want)).sum())


def _sparse_flops(module, args, output):
    """(hits, Cin, Cout) of one ``SubMConv`` / ``SparseConvDown`` call."""
    from ..models.layers import SubMConv

    x = args[0]
    cin, cout = int(module.weight.shape[1]), int(module.weight.shape[2])
    sites, shape = active_sites(x)
    if isinstance(module, SubMConv):
        ks = _triple(module.kernel_size)
        return conv_hits(sites, shape, sites, ks, 1, tuple((k - 1) // 2 for k in ks)), cin, cout
    out = output if not isinstance(output, tuple) else (None, output[1])
    out_sites, _ = active_sites(out)
    return conv_hits(sites, shape, out_sites, module.kernel_size, module.stride,
                     module.padding), cin, cout


def _dense_macs(module, args, output) -> int:
    """Multiply-adds of one dense module call, from its shapes."""
    from ..models.bevfusion.transfusion import MultiHeadAttention
    from ..models.heads.mg_head import TaskHead
    from ..models.necks.rpn import ConvBN

    if isinstance(module, TaskHead):
        n_out = module.conv_box.weight.shape[0] + module.conv_cls.weight.shape[0]
        return args[0].numel() * n_out
    if isinstance(module, MultiHeadAttention):  # q k^T and w v
        q, k = args[0], args[1]
        return 2 * q.shape[0] * q.shape[1] * k.shape[1] * q.shape[2]
    if isinstance(module, nn.Linear):
        return args[0].numel() * module.out_features
    w = module.weight
    per = w.numel() // w.shape[0]  # Cin/g x taps (conv) or Cout/g x taps (transposed)
    transposed = (isinstance(module, ConvBN) and module.transpose) or isinstance(
        module, nn.modules.conv._ConvTransposeNd)
    return (args[0].numel() if transposed else output.numel()) * per


def count_forward_flops(model: nn.Module, inputs: dict) -> FlopCount:
    """One inference forward ``model(**inputs)`` with the counting hooks on;
    returns its ``FlopCount``. The model runs in eval mode on the inputs'
    device, as the predict steps run it."""
    from ..models.bevfusion.transfusion import MultiHeadAttention
    from ..models.heads.mg_head import TaskHead
    from ..models.layers import SparseConvDown, SubMConv
    from ..models.necks.rpn import ConvBN

    dense_types = (nn.modules.conv._ConvNd, nn.Linear, ConvBN, TaskHead, MultiHeadAttention)
    count = FlopCount()
    handles = []

    def stage_of(name: str) -> List[int]:
        return count.stages.setdefault(name.split(".")[0], [0, 0])

    def on_sparse(name):
        def hook(module, args, output):
            hits, cin, cout = _sparse_flops(module, args, output)
            flops = 2 * hits * cin * cout
            count.sparse += flops
            count.hits += hits
            stage_of(name)[1] += flops
            count.sparse_convs.append((name, hits, cin, cout))
        return hook

    def on_dense(name):
        def hook(module, args, output):
            flops = 2 * _dense_macs(module, args, output)
            count.dense += flops
            stage_of(name)[0] += flops
        return hook

    for name, module in model.named_modules():
        if isinstance(module, (SubMConv, SparseConvDown)):
            handles.append(module.register_forward_hook(on_sparse(name)))
        elif isinstance(module, dense_types) and not _under_task_head(model, name):
            handles.append(module.register_forward_hook(on_dense(name)))
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            model(**inputs)
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    return count


def _under_task_head(model: nn.Module, name: str) -> bool:
    """Whether module ``name`` sits in a ``TaskHead``, which is counted
    whole: it holds ``nn.Conv2d`` weights that it applies as one matmul."""
    from ..models.heads.mg_head import TaskHead

    parts = name.split(".")
    for i in range(1, len(parts)):
        if isinstance(model.get_submodule(".".join(parts[:i])), TaskHead):
            return True
    return False
