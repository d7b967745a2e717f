"""Weights bridge: the JAX package's flax variables -> the port's state_dict.

The inverse of ``dal3d_tpu/models/convert_second.py`` (which maps det3d
torch checkpoints onto the flax trees): it takes the ``{"params",
"batch_stats"}`` trees of a banded ``FPNVoxelNet`` as nested dicts of numpy
arrays and returns the matching ``state_dict`` of
``models/detectors/voxelnet.py::FPNVoxelNet``.

Layouts:
  - sparse conv kernels [K, Cin, Cout] (z-major taps) carry over unchanged;
  - a flax ``Conv`` kernel [kh, kw, Cin, Cout] becomes [Cout, Cin, kh, kw];
  - a flax ``ConvTranspose`` kernel [kh, kw, Cin, Cout] becomes torch's
    [Cin, Cout, kh, kw] flipped in space (flax correlates, torch's transposed
    conv flips);
  - BN scale/bias/mean/var -> weight/bias/running_mean/running_var.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _flatten(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _conv2d(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (3, 2, 0, 1))


def _conv_transpose2d(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 0, 1))[:, :, ::-1, ::-1]


def _bn(params, stats, src: str, dst: str, out: dict) -> None:
    out[f"{dst}.weight"] = params[f"{src}/scale"]
    out[f"{dst}.bias"] = params[f"{src}/bias"]
    out[f"{dst}.running_mean"] = stats[f"{src}/mean"]
    out[f"{dst}.running_var"] = stats[f"{src}/var"]


def _block(params, stats, src: str, dst: str, out: dict) -> None:
    for j in (0, 1):
        out[f"{dst}.conv{j + 1}.weight"] = params[f"{src}/SubMConv_{j}/kernel"]
        out[f"{dst}.conv{j + 1}.bias"] = params[f"{src}/SubMConv_{j}/bias"]
        _bn(params, stats, f"{src}/MaskedBatchNorm_{j}", f"{dst}.bn{j + 1}", out)


def flax_to_state_dict(variables: dict, model) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} of a banded flax FPNVoxelNet -> state_dict
    of the port's ``model`` (an FPNVoxelNet; its neck gives the RPN layout)."""
    params = _flatten(variables["params"])
    stats = _flatten(variables.get("batch_stats", {}))
    out: Dict[str, np.ndarray] = {}

    bb = "FPNSpMiddleResNetFHD_0"
    out["backbone.l0.stem.weight"] = params[f"{bb}/l0/SubMConv_0/kernel"]
    _bn(params, stats, f"{bb}/l0/MaskedBatchNorm_0", "backbone.l0.stem_bn", out)
    for i in (0, 1):
        _block(params, stats, f"{bb}/l0/SparseBasicBlock_{i}", f"backbone.l0.block{i}", out)
    out["backbone.l0.down.weight"] = params[f"{bb}/l0/SparseConvDown_0/kernel"]
    _bn(params, stats, f"{bb}/l0/MaskedBatchNorm_1", "backbone.l0.down_bn", out)
    for s in (1, 2, 3):
        src, dst = f"{bb}/stage{s}", f"backbone.stage{s}"
        for i in (0, 1):
            _block(params, stats, f"{src}/SparseBasicBlock_{i}", f"{dst}.block{i}", out)
        out[f"{dst}.down.weight"] = params[f"{src}/SparseConvDown_0/kernel"]
        _bn(params, stats, f"{src}/MaskedBatchNorm_0", f"{dst}.down_bn", out)

    # flax numbers Conv / ConvTranspose / BatchNorm2d in traversal order:
    # each block's convs, then that block's upsample branch
    rp = "RPN_0"
    n = {"Conv": 0, "ConvTranspose": 0, "BatchNorm2d": 0}

    def take(kind: str) -> str:
        name = f"{rp}/{kind}_{n[kind]}"
        n[kind] += 1
        return name

    neck = model.neck
    for b, block in enumerate(neck.blocks):
        for j in range(len(block)):
            out[f"neck.blocks.{b}.{j}.weight"] = _conv2d(params[take("Conv") + "/kernel"])
            _bn(params, stats, take("BatchNorm2d") + "/BatchNorm_0",
                f"neck.blocks.{b}.{j}.bn", out)
        d = b - neck.upsample_start
        if d >= 0:
            if neck.deblocks[d].transpose:
                w = _conv_transpose2d(params[take("ConvTranspose") + "/kernel"])
            else:
                w = _conv2d(params[take("Conv") + "/kernel"])
            out[f"neck.deblocks.{d}.weight"] = w
            _bn(params, stats, take("BatchNorm2d") + "/BatchNorm_0",
                f"neck.deblocks.{d}.bn", out)

    hd = "MultiGroupHead_0"
    for t in range(len(model.head.tasks)):
        for conv, k in (("conv_box", 2 * t), ("conv_cls", 2 * t + 1)):
            out[f"head.tasks.{t}.{conv}.weight"] = _conv2d(params[f"{hd}/Conv_{k}/kernel"])
            out[f"head.tasks.{t}.{conv}.bias"] = params[f"{hd}/Conv_{k}/bias"]

    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def load_flax_variables(model, variables: dict):
    """Load flax variables into the port's FPNVoxelNet (strict: every
    parameter and buffer must be covered)."""
    sd = flax_to_state_dict(variables, model)
    model.load_state_dict(sd, strict=True)
    return model
