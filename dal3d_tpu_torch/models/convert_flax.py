"""Weights bridge: the JAX package's flax variables -> the port's state_dict
(and, for the partial-label ``Estimator``, back).

The inverse of ``dal3d_tpu/models/convert_second.py`` (which maps det3d
torch checkpoints onto the flax trees): it takes the ``{"params",
"batch_stats"}`` trees of a banded ``FPNVoxelNet``, or of a lidar-only
``BEVFusion``, as nested dicts of numpy arrays and returns the matching
``state_dict`` of ``models/detectors/voxelnet.py::FPNVoxelNet`` or
``models/bevfusion/bevfusion.py::BEVFusion``.

Layouts:
  - sparse conv kernels [K, Cin, Cout] (z-major taps) carry over unchanged;
  - a flax ``Conv`` kernel [kh, kw, Cin, Cout] becomes [Cout, Cin, kh, kw];
  - a flax ``ConvTranspose`` kernel [kh, kw, Cin, Cout] becomes torch's
    [Cin, Cout, kh, kw] flipped in space (flax correlates, torch's transposed
    conv flips);
  - BN scale/bias/mean/var -> weight/bias/running_mean/running_var;
  - a flax ``Dense`` kernel [in, out] becomes an ``nn.Linear`` weight
    [out, in]; the attention projections' [d, heads, d/heads] (query, key,
    value) and [heads, d/heads, d] (out) kernels are flattened over
    (heads, d/heads) first.

The estimator's weights also go the other way: ``estimator_to_flat`` gives
the flat ``Dense_<i>/kernel`` / ``Dense_<i>/bias`` names and [in, out]
layouts of JAX's ``estimator.npz`` (its ``convert_second.flatten_tree`` of
the flax params), which ``estimator_flax_to_state_dict`` reads back.
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
        if f"{src}/SubMConv_{j}/bias" in params:  # the BEVFusion encoder's are bias-free
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


def _dense(params, src: str, dst: str, out: dict) -> None:
    out[f"{dst}.weight"] = params[f"{src}/kernel"].T
    if f"{src}/bias" in params:
        out[f"{dst}.bias"] = params[f"{src}/bias"]


def _attention(params, src: str, dst: str, out: dict) -> None:
    for name in ("query", "key", "value"):
        k = params[f"{src}/{name}/kernel"]  # [d, heads, d/heads]
        out[f"{dst}.{name}.weight"] = k.reshape(k.shape[0], -1).T
        out[f"{dst}.{name}.bias"] = params[f"{src}/{name}/bias"].reshape(-1)
    k = params[f"{src}/out/kernel"]  # [heads, d/heads, d]
    out[f"{dst}.out.weight"] = k.reshape(-1, k.shape[-1]).T
    out[f"{dst}.out.bias"] = params[f"{src}/out/bias"]


def bevfusion_flax_to_state_dict(variables: dict, model) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} of a lidar-only flax BEVFusion -> state_dict
    of the port's ``model`` (a BEVFusion; its stages give the layout)."""
    params = _flatten(variables["params"])
    stats = _flatten(variables.get("batch_stats", {}))
    out: Dict[str, np.ndarray] = {}

    # encoder: flax numbers blocks, downsamples and norms in traversal order
    se, enc = "SparseEncoder_0", model.encoder
    out["encoder.stem.weight"] = params[f"{se}/SubMConv_0/kernel"]
    _bn(params, stats, f"{se}/MaskedBatchNorm_0", "encoder.stem_bn", out)
    n_block = n_down = 0
    for i, stage in enumerate(enc.stages):
        for j in range(len(stage.blocks)):
            _block(params, stats, f"{se}/SparseBasicBlock_{n_block}",
                   f"encoder.stages.{i}.blocks.{j}", out)
            n_block += 1
        if stage.down is not None:
            out[f"encoder.stages.{i}.down.weight"] = params[f"{se}/SparseConvDown_{n_down}/kernel"]
            _bn(params, stats, f"{se}/MaskedBatchNorm_{n_down + 1}",
                f"encoder.stages.{i}.down_bn", out)
            n_down += 1
    out["encoder.conv_out.weight"] = params[f"{se}/SparseConvDown_{n_down}/kernel"]
    _bn(params, stats, f"{se}/MaskedBatchNorm_{n_down + 1}", "encoder.conv_out_bn", out)

    for b, block in enumerate(model.decoder.blocks):
        for j in range(len(block)):
            n = sum(len(blk) for blk in model.decoder.blocks[:b]) + j
            out[f"decoder.blocks.{b}.{j}.weight"] = _conv2d(params[f"SECOND_0/Conv_{n}/kernel"])
            _bn(params, stats, f"SECOND_0/BatchNorm2d_{n}/BatchNorm_0",
                f"decoder.blocks.{b}.{j}.bn", out)
    n = {"Conv": 0, "ConvTranspose": 0}
    for i, deblock in enumerate(model.neck.deblocks):
        kind = "ConvTranspose" if deblock.transpose else "Conv"
        k = params[f"SECONDFPN_0/{kind}_{n[kind]}/kernel"]
        n[kind] += 1
        out[f"neck.deblocks.{i}.weight"] = _conv_transpose2d(k) if deblock.transpose else _conv2d(k)
        _bn(params, stats, f"SECONDFPN_0/BatchNorm2d_{i}/BatchNorm_0",
            f"neck.deblocks.{i}.bn", out)

    hd = "TransFusionHead_0"
    for name in ("shared_conv", "heatmap_conv", "heatmap_out"):
        out[f"head.{name}.weight"] = _conv2d(params[f"{hd}/{name}/kernel"])
        if f"{hd}/{name}/bias" in params:
            out[f"head.{name}.bias"] = params[f"{hd}/{name}/bias"]
    _bn(params, stats, f"{hd}/heatmap_bn/BatchNorm_0", "head.heatmap_bn", out)
    _dense(params, f"{hd}/class_encoding", "head.class_encoding", out)
    for pe in ("self_posembed", "cross_posembed"):
        _dense(params, f"{hd}/{pe}/fc1", f"head.{pe}.fc1", out)
        _bn(params, stats, f"{hd}/{pe}/bn/BatchNorm_0", f"head.{pe}.bn", out)
        _dense(params, f"{hd}/{pe}/fc2", f"head.{pe}.fc2", out)
    dec = f"{hd}/decoder0"
    _attention(params, f"{dec}/MultiHeadDotProductAttention_0", "head.decoder0.self_attn", out)
    _attention(params, f"{dec}/MultiHeadDotProductAttention_1", "head.decoder0.cross_attn", out)
    for j in range(3):
        out[f"head.decoder0.norm{j + 1}.weight"] = params[f"{dec}/LayerNorm_{j}/scale"]
        out[f"head.decoder0.norm{j + 1}.bias"] = params[f"{dec}/LayerNorm_{j}/bias"]
    _dense(params, f"{dec}/Dense_0", "head.decoder0.ffn1", out)
    _dense(params, f"{dec}/Dense_1", "head.decoder0.ffn2", out)
    for name in ("center", "height", "dim", "rot", "vel", "heatmap"):
        src, dst = f"{hd}/pred_{name}", f"head.pred_{name}"
        _dense(params, f"{src}/conv0", f"{dst}.conv0", out)
        _bn(params, stats, f"{src}/bn0/BatchNorm_0", f"{dst}.bn0", out)
        _dense(params, f"{src}/out", f"{dst}.out", out)

    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def load_flax_bevfusion(model, variables: dict):
    """Load a lidar-only flax BEVFusion's variables into the port's BEVFusion
    (strict: every parameter and buffer must be covered)."""
    model.load_state_dict(bevfusion_flax_to_state_dict(variables, model), strict=True)
    return model


def mg_head_flax_to_state_dict(variables: dict, head) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} of a flax ``MultiGroupIoUHead`` or
    ``MultiGroupLossHead`` -> state_dict of the port's head of the same kind
    (``models/heads/mg_loss_head.py``)."""
    params = _flatten(variables["params"])
    stats = _flatten(variables.get("batch_stats", {}))
    out: Dict[str, np.ndarray] = {}
    hd = "MultiGroupHead_0"
    for t in range(len(head.head.tasks)):
        for conv, k in (("conv_box", 2 * t), ("conv_cls", 2 * t + 1)):
            out[f"head.tasks.{t}.{conv}.weight"] = _conv2d(params[f"{hd}/Conv_{k}/kernel"])
            out[f"head.tasks.{t}.{conv}.bias"] = params[f"{hd}/Conv_{k}/bias"]
    branch = "iou" if hasattr(head, "iou") else "loss"
    for t in range(len(getattr(head, branch))):
        for j in (0, 1):
            src, dst = f"{branch}_mlp{j}_{t}", f"{branch}.{t}.mlp{j}"
            out[f"{dst}.weight"] = _conv2d(params[f"{src}/kernel"])
            out[f"{dst}.bias"] = params[f"{src}/bias"]
        _bn(params, stats, f"{branch}_bn_{t}", f"{branch}.{t}.bn", out)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def _estimator_names(est):
    """(flax Dense name, port Linear name) pairs in flax's numbering."""
    ports = [f"point_mlp.{i}" for i in range(len(est.point_mlp))] + ["fc", "out"]
    return [(f"Dense_{i}", p) for i, p in enumerate(ports)]


def estimator_flax_to_state_dict(params: dict, est) -> Dict[str, torch.Tensor]:
    """An estimator's flax params, nested (``{"Dense_0": {"kernel", "bias"},
    ...}``) or flat (``"Dense_0/kernel"``, as in ``estimator.npz``) ->
    state_dict of the port's ``Estimator`` ``est``."""
    flat = _flatten(params) if any(isinstance(v, dict) for v in params.values()) else {
        k: np.asarray(v, np.float32) for k, v in params.items()}
    out: Dict[str, np.ndarray] = {}
    for src, dst in _estimator_names(est):
        _dense(flat, src, dst, out)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def estimator_to_flat(est) -> Dict[str, np.ndarray]:
    """The port's ``Estimator`` -> JAX's flat estimator names and layouts
    (``Dense_<i>/kernel`` [in, out], ``Dense_<i>/bias`` [out]), f32 numpy."""
    sd = {k: v.detach().cpu().float().numpy() for k, v in est.state_dict().items()}
    out = {}
    for flax_name, port in _estimator_names(est):
        out[f"{flax_name}/bias"] = sd[f"{port}.bias"]
        out[f"{flax_name}/kernel"] = np.ascontiguousarray(sd[f"{port}.weight"].T)
    return out
