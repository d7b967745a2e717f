"""Weights bridge: the JAX package's flax variables -> the port's state_dict
(and, for the partial-label ``Estimator``, back).

The inverse of ``dal3d_tpu/models/convert_second.py`` (which maps det3d
torch checkpoints onto the flax trees): it takes the ``{"params",
"batch_stats"}`` trees of an ``FPNVoxelNet`` (any backbone engine), of a
``BEVFusion``, of a ``PointPillars``, of an ``FPN``, of an image backbone
or of an ``AlignFeatureAggregation``, as nested dicts of
numpy arrays and returns the matching ``state_dict`` of the port's module
of that name.

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


def _rpn(params, stats, rp: str, neck, dst: str, out: dict) -> None:
    """A flax RPN at ``rp`` -> the port's RPN ``neck`` at ``dst``. flax
    numbers Conv / ConvTranspose / BatchNorm2d in traversal order: each
    block's convs, then that block's upsample branch."""
    n = {"Conv": 0, "ConvTranspose": 0, "BatchNorm2d": 0}

    def take(kind: str) -> str:
        name = f"{rp}/{kind}_{n[kind]}"
        n[kind] += 1
        return name

    for b, block in enumerate(neck.blocks):
        for j in range(len(block)):
            out[f"{dst}.blocks.{b}.{j}.weight"] = _conv2d(params[take("Conv") + "/kernel"])
            _bn(params, stats, take("BatchNorm2d") + "/BatchNorm_0",
                f"{dst}.blocks.{b}.{j}.bn", out)
        d = b - neck.upsample_start
        if d >= 0:
            if neck.deblocks[d].transpose:
                w = _conv_transpose2d(params[take("ConvTranspose") + "/kernel"])
            else:
                w = _conv2d(params[take("Conv") + "/kernel"])
            out[f"{dst}.deblocks.{d}.weight"] = w
            _bn(params, stats, take("BatchNorm2d") + "/BatchNorm_0",
                f"{dst}.deblocks.{d}.bn", out)


def _mg_head(params, hd: str, head, dst: str, out: dict) -> None:
    """A flax MultiGroupHead at ``hd`` -> the port's at ``dst``: the 1x1
    (box, cls) conv pair of each task, numbered Conv_{2t}, Conv_{2t+1}."""
    for t in range(len(head.tasks)):
        for conv, k in (("conv_box", 2 * t), ("conv_cls", 2 * t + 1)):
            out[f"{dst}.tasks.{t}.{conv}.weight"] = _conv2d(params[f"{hd}/Conv_{k}/kernel"])
            out[f"{dst}.tasks.{t}.{conv}.bias"] = params[f"{hd}/Conv_{k}/bias"]


def flax_to_state_dict(variables: dict, model) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} of a flax FPNVoxelNet -> state_dict of the
    port's ``model`` (an FPNVoxelNet; its neck gives the RPN layout). The
    banded, brick and hybrid engines nest L0 under
    ``FPNSpMiddleResNetFHD_0/l0`` (hybrid's is the remat-wrapped
    ``_L0GatherSection``, under the same name); the gather and dense engines
    inline it under ``FPNSpMiddleResNetFHD_0`` (the port's names are
    ``backbone.l0.*`` for all). The stages are ``stage{1..3}`` on every
    engine, remat-wrapped or not."""
    params = _flatten(variables["params"])
    stats = _flatten(variables.get("batch_stats", {}))
    out: Dict[str, np.ndarray] = {}

    bb = "FPNSpMiddleResNetFHD_0"
    l0 = f"{bb}/l0" if model.backbone.impl in ("banded", "brick", "hybrid") else bb
    out["backbone.l0.stem.weight"] = params[f"{l0}/SubMConv_0/kernel"]
    _bn(params, stats, f"{l0}/MaskedBatchNorm_0", "backbone.l0.stem_bn", out)
    for i in (0, 1):
        _block(params, stats, f"{l0}/SparseBasicBlock_{i}", f"backbone.l0.block{i}", out)
    out["backbone.l0.down.weight"] = params[f"{l0}/SparseConvDown_0/kernel"]
    _bn(params, stats, f"{l0}/MaskedBatchNorm_1", "backbone.l0.down_bn", out)
    for s in (1, 2, 3):
        src, dst = f"{bb}/stage{s}", f"backbone.stage{s}"
        for i in (0, 1):
            _block(params, stats, f"{src}/SparseBasicBlock_{i}", f"{dst}.block{i}", out)
        out[f"{dst}.down.weight"] = params[f"{src}/SparseConvDown_0/kernel"]
        _bn(params, stats, f"{src}/MaskedBatchNorm_0", f"{dst}.down_bn", out)

    _rpn(params, stats, "RPN_0", model.neck, "neck", out)
    _mg_head(params, "MultiGroupHead_0", model.head, "head", out)
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


def _ln(params, src: str, dst: str, out: dict) -> None:
    out[f"{dst}.weight"] = params[f"{src}/scale"]
    out[f"{dst}.bias"] = params[f"{src}/bias"]


def _conv_bn(params, stats, conv: str, bn: str, dst: str, out: dict) -> None:
    """A flax Conv (bias if it has one) + BatchNorm2d -> a ``Conv2dBN``."""
    out[f"{dst}.conv.weight"] = _conv2d(params[f"{conv}/kernel"])
    if f"{conv}/bias" in params:
        out[f"{dst}.conv.bias"] = params[f"{conv}/bias"]
    _bn(params, stats, f"{bn}/BatchNorm_0", f"{dst}.bn", out)


def swin_flax_to_state_dict(params: Dict[str, np.ndarray], swin, src: str = "",
                            dst: str = "") -> Dict[str, np.ndarray]:
    """Flat flax params of a ``SwinTransformer`` (names prefixed by ``src``,
    e.g. ``"SwinTransformer_0/"``) -> the port's names prefixed by ``dst``
    (``swin``, the port's module, gives the depths and output stages). flax
    numbers its modules in creation order: ``Conv_0`` / ``LayerNorm_0`` the
    patch embed, ``SwinBlock_<n>`` over all stages, ``PatchMerging_<i>``
    before stage i + 1, ``LayerNorm_<1..>`` the output norms in order."""
    out: Dict[str, np.ndarray] = {}
    out[f"{dst}patch_embed.proj.weight"] = _conv2d(params[f"{src}Conv_0/kernel"])
    out[f"{dst}patch_embed.proj.bias"] = params[f"{src}Conv_0/bias"]
    _ln(params, f"{src}LayerNorm_0", f"{dst}patch_embed.norm", out)
    n_block, n_norm = 0, 1
    for i, stage in enumerate(swin.layers):
        for j in range(len(stage.blocks)):
            b, t = f"{src}SwinBlock_{n_block}", f"{dst}layers.{i}.blocks.{j}"
            _ln(params, f"{b}/LayerNorm_0", f"{t}.norm1", out)
            _dense(params, f"{b}/WindowAttention_0/Dense_0", f"{t}.attn.qkv", out)
            _dense(params, f"{b}/WindowAttention_0/Dense_1", f"{t}.attn.proj", out)
            out[f"{t}.attn.relative_position_bias_table"] = params[
                f"{b}/WindowAttention_0/relative_position_bias_table"]
            _ln(params, f"{b}/LayerNorm_1", f"{t}.norm2", out)
            _dense(params, f"{b}/Dense_0", f"{t}.mlp.fc1", out)
            _dense(params, f"{b}/Dense_1", f"{t}.mlp.fc2", out)
            n_block += 1
        if stage.downsample is not None:
            m, d = f"{src}PatchMerging_{i}", f"{dst}layers.{i}.downsample"
            _ln(params, f"{m}/LayerNorm_0", f"{d}.norm", out)
            _dense(params, f"{m}/Dense_0", f"{d}.reduction", out)
        if i in swin.out_indices:
            _ln(params, f"{src}LayerNorm_{n_norm}", f"{dst}norm{i}", out)
            n_norm += 1
    return out


def lss_fpn_flax_to_state_dict(params, stats, neck, src: str = "",
                               dst: str = "") -> Dict[str, np.ndarray]:
    """A flax ``GeneralizedLSSFPN`` (names prefixed by ``src``) -> the port's
    ``neck`` (prefixed by ``dst``). flax creates the levels coarse to fine:
    ``Conv_{2m}`` / ``Conv_{2m+1}`` serve level n - 1 - m."""
    out: Dict[str, np.ndarray] = {}
    n = len(neck.lateral_convs)
    for m in range(n):
        lvl = n - 1 - m
        for k, name in ((2 * m, "lateral_convs"), (2 * m + 1, "fpn_convs")):
            _conv_bn(params, stats, f"{src}Conv_{k}", f"{src}BatchNorm2d_{k}",
                     f"{dst}{name}.{lvl}", out)
    return out


def vtransform_flax_to_state_dict(params, stats, vt, src: str = "",
                                  dst: str = "") -> Dict[str, np.ndarray]:
    """A flax ``DepthLSSTransform`` or ``LSSTransform`` -> the port's ``vt``
    of the same kind. flax numbers the depth branch's convs first
    (``Conv_0..2``), then the depthnet's (``Conv_3, 4``), the 1x1 output
    conv, and last the BEV downsample's three."""
    out: Dict[str, np.ndarray] = {}
    names = ([f"dtransform.{i}" for i in range(3)] + [f"depthnet.{i}" for i in range(2)]
             if hasattr(vt, "dtransform") else [])
    for k, name in enumerate(names):
        _conv_bn(params, stats, f"{src}Conv_{k}", f"{src}BatchNorm2d_{k}", f"{dst}{name}", out)
    k = len(names)
    out[f"{dst}depth_out.weight"] = _conv2d(params[f"{src}Conv_{k}/kernel"])
    out[f"{dst}depth_out.bias"] = params[f"{src}Conv_{k}/bias"]
    if vt.downsample is not None:
        for i in range(3):
            _conv_bn(params, stats, f"{src}Conv_{k + 1 + i}", f"{src}BatchNorm2d_{k + i}",
                     f"{dst}downsample.{i}", out)
    return out


def _camera_flax_to_state_dict(params, stats, model, out: dict) -> None:
    """The camera branch and the fuser of a flax BEVFusion -> the port's
    ``camera_backbone`` / ``camera_neck`` / ``camera_vtransform`` /
    ``fuser``."""
    out.update(swin_flax_to_state_dict(params, model.camera_backbone, "SwinTransformer_0/",
                                       "camera_backbone."))
    out.update(lss_fpn_flax_to_state_dict(params, stats, model.camera_neck,
                                          "GeneralizedLSSFPN_0/", "camera_neck."))
    vt = model.camera_vtransform
    src = "DepthLSSTransform_0/" if hasattr(vt, "dtransform") else "LSSTransform_0/"
    out.update(vtransform_flax_to_state_dict(params, stats, vt, src, "camera_vtransform."))
    if model.fuser is not None:
        _conv_bn(params, stats, "ConvFuser_0/Conv_0", "ConvFuser_0/BatchNorm2d_0", "fuser.fuse",
                 out)


def bevfusion_flax_to_state_dict(variables: dict, model) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} of a flax BEVFusion -> state_dict of the
    port's ``model`` (a BEVFusion; its stages give the layout): the camera
    branch and fuser, the lidar encoder, the decoder and neck, the
    TransFusion or CenterPoint head, and the map-segmentation head."""
    params = _flatten(variables["params"])
    stats = _flatten(variables.get("batch_stats", {}))
    out: Dict[str, np.ndarray] = {}
    if model.with_camera:
        _camera_flax_to_state_dict(params, stats, model, out)
    if model.with_lidar:
        _lidar_encoder(params, stats, model.encoder, out)
    _decoder_and_head(params, stats, model, out)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def _lidar_encoder(params, stats, enc, out: dict) -> None:
    # flax numbers blocks, downsamples and norms in traversal order
    se = "SparseEncoder_0"
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


def _decoder_and_head(params, stats, model, out: dict) -> None:
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

    if model.head_type == "centerpoint":
        out.update(center_head_flax_to_state_dict(params, stats, model.head, "CenterHead_0/",
                                                  "head."))
    else:
        _transfusion_head(params, stats, out)
    # a tree without the seg head (a converted reference checkpoint: JAX's
    # converter maps no heads.map.*) leaves it out; a strict load still
    # refuses the gap
    if model.seg_head is not None and "BEVSegmentationHead_0/Conv_0/kernel" in params:
        out.update(seg_head_flax_to_state_dict(params, stats, model.seg_head,
                                               "BEVSegmentationHead_0/", "seg_head."))


def center_head_flax_to_state_dict(params, stats, head, src: str = "",
                                   dst: str = "") -> Dict[str, np.ndarray]:
    """A flax ``CenterHead`` (names prefixed by ``src``) -> the port's
    ``head`` (prefixed by ``dst``): the shared ``Conv_0`` / ``BatchNorm2d_0``,
    then ``_Branch_<6t + j>`` (task t's heatmap, reg, height, dim, rot, vel in
    that order), each ``Conv_0`` / ``BatchNorm2d_0`` and the biased
    ``Conv_1``."""
    out: Dict[str, np.ndarray] = {}
    _conv_bn(params, stats, f"{src}Conv_0", f"{src}BatchNorm2d_0", f"{dst}shared", out)
    n = 0
    for t, task in enumerate(head.tasks):
        for name in task:
            b, d = f"{src}_Branch_{n}", f"{dst}tasks.{t}.{name}"
            _conv_bn(params, stats, f"{b}/Conv_0", f"{b}/BatchNorm2d_0", f"{d}.conv", out)
            out[f"{d}.out.weight"] = _conv2d(params[f"{b}/Conv_1/kernel"])
            out[f"{d}.out.bias"] = params[f"{b}/Conv_1/bias"]
            n += 1
    return out


def seg_head_flax_to_state_dict(params, stats, head, src: str = "",
                                dst: str = "") -> Dict[str, np.ndarray]:
    """A flax ``BEVSegmentationHead`` -> the port's ``head``: ``Conv_i`` /
    ``BatchNorm2d_i`` per hidden conv, then the biased 1x1 ``Conv_n``."""
    out: Dict[str, np.ndarray] = {}
    n = len(head.convs)
    for i in range(n):
        _conv_bn(params, stats, f"{src}Conv_{i}", f"{src}BatchNorm2d_{i}", f"{dst}convs.{i}", out)
    out[f"{dst}out.weight"] = _conv2d(params[f"{src}Conv_{n}/kernel"])
    out[f"{dst}out.bias"] = params[f"{src}Conv_{n}/bias"]
    return out


def _transfusion_head(params, stats, out: dict) -> None:
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


def load_flax_bevfusion(model, variables: dict):
    """Load a flax BEVFusion's variables into the port's BEVFusion (strict:
    every parameter and buffer must be covered)."""
    model.load_state_dict(bevfusion_flax_to_state_dict(variables, model), strict=True)
    return model


def mg_head_flax_to_state_dict(variables: dict, head) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} of a flax ``MultiGroupIoUHead`` or
    ``MultiGroupLossHead`` -> state_dict of the port's head of the same kind
    (``models/heads/mg_loss_head.py``)."""
    params = _flatten(variables["params"])
    stats = _flatten(variables.get("batch_stats", {}))
    out: Dict[str, np.ndarray] = {}
    _mg_head(params, "MultiGroupHead_0", head.head, "head", out)
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


def point_pillars_flax_to_state_dict(variables: dict, model) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} of a flax ``PointPillars`` -> state_dict of
    the port's ``models/detectors/point_pillars.py::PointPillars``: the PFN's
    ``Dense_<i>`` kernels [in, out] and ``MaskedBatchNorm_<i>``, then the RPN
    and the head as in ``flax_to_state_dict``."""
    params = _flatten(variables["params"])
    stats = _flatten(variables.get("batch_stats", {}))
    out: Dict[str, np.ndarray] = {}
    pf = "PillarFeatureNet_0"
    for i in range(len(model.pfn.linears)):
        out[f"pfn.linears.{i}.weight"] = params[f"{pf}/Dense_{i}/kernel"].T
        _bn(params, stats, f"{pf}/MaskedBatchNorm_{i}", f"pfn.norms.{i}", out)
    _rpn(params, stats, "RPN_0", model.neck, "neck", out)
    _mg_head(params, "MultiGroupHead_0", model.head, "head", out)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def fpn_flax_to_state_dict(params: dict, fpn) -> Dict[str, torch.Tensor]:
    """The params of a flax ``FPN`` initialised alone -> state_dict of the
    port's ``models/necks/fpn.py::FPN``: flax numbers the n lateral convs
    Conv_0..n-1, then the n output convs Conv_n..2n-1."""
    flat = _flatten(params)
    out: Dict[str, np.ndarray] = {}
    n = len(fpn.lateral)
    for i in range(2 * n):
        dst = f"lateral.{i}" if i < n else f"out.{i - n}"
        out[f"{dst}.weight"] = _conv2d(flat[f"Conv_{i}/kernel"])
        out[f"{dst}.bias"] = flat[f"Conv_{i}/bias"]
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


def image_backbone_flax_to_state_dict(variables: dict, model) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} of a flax ``ResNet`` / ``SENet`` / ``SSDVGG``
    (``dal3d_tpu/models/backbones/image.py``) -> state_dict of the port's
    module of that name (``models/backbones/image.py``). flax names a
    block's submodules in the order its ``__call__`` makes them: ``Conv_0``,
    ``BatchNorm2d_0``, ``Conv_1``, ``BatchNorm2d_1``, the SE block's
    ``Dense_0`` and ``Dense_1``, and the projection ``Conv_2`` /
    ``BatchNorm2d_2``; the blocks ``_BasicBlock_<i>`` count across the
    stages. SSDVGG's convs are ``Conv_0``.. in order, fc6 and fc7 last."""
    params = _flatten(variables["params"])
    stats = _flatten(variables.get("batch_stats", {}))
    out: Dict[str, np.ndarray] = {}

    def bn(src, dst):
        _bn(params, stats, f"{src}/BatchNorm_0", dst, out)

    def conv(src, dst):
        out[f"{dst}.weight"] = _conv2d(params[f"{src}/kernel"])
        if f"{src}/bias" in params:
            out[f"{dst}.bias"] = params[f"{src}/bias"]

    if hasattr(model, "fc6"):  # SSDVGG
        convs = [f"stages.{i}.{j}" for i, s in enumerate(model.stages) for j in range(len(s))]
        for n, dst in enumerate(convs + ["fc6", "fc7"]):
            conv(f"Conv_{n}", dst)
    else:
        conv("Conv_0", "stem")
        bn("BatchNorm2d_0", "stem_bn")
        blocks = [f"stages.{i}.{j}" for i, s in enumerate(model.stages) for j in range(len(s))]
        for n, dst in enumerate(blocks):
            src = f"_BasicBlock_{n}"
            for k in (0, 1):
                conv(f"{src}/Conv_{k}", f"{dst}.conv{k + 1}")
                bn(f"{src}/BatchNorm2d_{k}", f"{dst}.bn{k + 1}")
            if f"{src}/Dense_0/kernel" in params:
                _dense(params, f"{src}/Dense_0", f"{dst}.se.0", out)
                _dense(params, f"{src}/Dense_1", f"{dst}.se.2", out)
            if f"{src}/Conv_2/kernel" in params:
                conv(f"{src}/Conv_2", f"{dst}.proj.0")
                bn(f"{src}/BatchNorm2d_2", f"{dst}.proj.1")
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def align_aggregation_flax_to_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """The params of a flax ``AlignFeatureAggregation``
    (``dal3d_tpu/ops/align_aggregation.py``) -> state_dict of the port's
    (``ops/align_aggregation.py``): ``embed_keyframe``, ``embed_current``
    and ``agg_conv1``-``3``, kernel and bias each."""
    flat = _flatten(params)
    out: Dict[str, np.ndarray] = {}
    for name in ("embed_keyframe", "embed_current", "agg_conv1", "agg_conv2", "agg_conv3"):
        out[f"{name}.weight"] = _conv2d(flat[f"{name}/kernel"])
        out[f"{name}.bias"] = flat[f"{name}/bias"]
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}
