"""Reference BEVFusion checkpoint -> the port's BEVFusion (port of
``dal3d_tpu/models/bevfusion/convert_bevfusion.py``).

Maps the reference's torch ``state_dict`` (the mmdet3d module tree:
``encoders.lidar.backbone``, ``decoder.{backbone,neck}``, ``heads.object``,
and in a camera + lidar checkpoint ``encoders.camera.{backbone,neck,
vtransform}`` and ``fuser.{0,1}``) onto the flax names and layouts of the
JAX package's BEVFusion, then onto the port's ``state_dict`` through the
weights bridge (``models/convert_flax.py::bevfusion_flax_to_state_dict``),
so the port's result equals the route through JAX's converter bit for bit
(pure copies and transposes). The Swin sub-tree goes through
``convert_swin.py`` on the ``encoders.camera.backbone.`` slice.

Layout rules:
- the reference's BEV maps are [B, C, X, Y] (its voxelizer emits (x, y, z)
  over a [1440, 1440, 41] grid); the port's are [B, Y, X, C]. Every BEV conv
  (the fuser, the decoder, the head, the view transform's downsample)
  therefore converts with its two spatial kernel axes swapped; image-space
  convs (Swin, the LSS FPN, the depth branch and depthnet) take the plain
  [Cout, Cin, kh, kw] -> [kh, kw, Cin, Cout] transpose;
- the reference's spconv weights are [kx, ky, kz, Cin, Cout]; the port's
  sparse convs take z-major flat taps [kz * ky * kx, Cin, Cout];
- torch ``MultiheadAttention``'s in_proj [3d, d] splits into query / key /
  value; a ``Conv1d`` of kernel 1 is a dense layer;
- BN weight / bias / running_mean / running_var carry over.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..convert_flax import bevfusion_flax_to_state_dict
from ..convert_second import copy_converted, load_raw_state_dict_npz

def _f32(v):
    return np.asarray(v, np.float32)


def _img_conv_w(w):
    """torch [Cout, Cin, kh, kw] in image space -> flax [kh, kw, Cin, Cout]."""
    return np.ascontiguousarray(np.transpose(_f32(w), (2, 3, 1, 0)))


def _bev_conv_w(w):
    """torch [Cout, Cin, kh, kw] in BEV space -> flax [kw, kh, Cin, Cout]."""
    return np.ascontiguousarray(np.transpose(_f32(w), (3, 2, 1, 0)))


def _bev_convT_w(w):
    """torch ConvTranspose2d [Cin, Cout, kh, kw] in BEV space -> flax
    [kw, kh, Cin, Cout], flipped in space (torch's transposed conv flips the
    kernel against flax's)."""
    return np.ascontiguousarray(np.transpose(_f32(w)[:, :, ::-1, ::-1], (3, 2, 0, 1)))


def _dense(w):
    return np.ascontiguousarray(_f32(w).T)


def _c1d(w):
    """Conv1d of kernel 1 [Cout, Cin, 1] -> dense [Cin, Cout]."""
    return np.ascontiguousarray(_f32(w)[:, :, 0].T)


def _spconv_w(w):
    """[kx, ky, kz, Cin, Cout] -> z-major flat [kz * ky * kx, Cin, Cout]."""
    w = _f32(w)
    kx, ky, kz, ci, co = w.shape
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0, 3, 4)).reshape(kz * ky * kx, ci, co))


class _Ctx:
    """The reference state_dict and the flat flax-named params / batch
    statistics written from it."""

    def __init__(self, sd):
        self.sd = sd
        self.params: Dict[str, np.ndarray] = {}
        self.stats: Dict[str, np.ndarray] = {}

    def bn(self, pref, dst):
        self.params[f"{dst}/scale"] = _f32(self.sd[f"{pref}.weight"])
        self.params[f"{dst}/bias"] = _f32(self.sd[f"{pref}.bias"])
        self.stats[f"{dst}/mean"] = _f32(self.sd[f"{pref}.running_mean"])
        self.stats[f"{dst}/var"] = _f32(self.sd[f"{pref}.running_var"])

    def conv(self, pref, dst, kind):
        self.params[f"{dst}/kernel"] = kind(self.sd[f"{pref}.weight"])
        if f"{pref}.bias" in self.sd:
            self.params[f"{dst}/bias"] = _f32(self.sd[f"{pref}.bias"])

    def attn(self, pref, dst, heads):
        d = int(self.sd[f"{pref}.in_proj_weight"].shape[1])
        hd = d // heads
        w = _f32(self.sd[f"{pref}.in_proj_weight"])  # [3d, d]
        b = _f32(self.sd[f"{pref}.in_proj_bias"])
        for i, name in enumerate(("query", "key", "value")):
            self.params[f"{dst}/{name}/kernel"] = np.ascontiguousarray(
                w[i * d:(i + 1) * d].T.reshape(d, heads, hd))
            self.params[f"{dst}/{name}/bias"] = b[i * d:(i + 1) * d].reshape(heads, hd)
        self.params[f"{dst}/out/kernel"] = np.ascontiguousarray(
            _f32(self.sd[f"{pref}.out_proj.weight"]).T.reshape(heads, hd, d))
        self.params[f"{dst}/out/bias"] = _f32(self.sd[f"{pref}.out_proj.bias"])


def _sparse_encoder(c: _Ctx, src: str, dst: str) -> None:
    """encoders.lidar.backbone (mmdet3d SparseEncoder, basic blocks)."""
    c.conv(f"{src}.conv_input.0", f"{dst}/SubMConv_0", _spconv_w)
    c.bn(f"{src}.conv_input.1", f"{dst}/MaskedBatchNorm_0")
    blk = 0
    for stage in range(4):
        layer = f"{src}.encoder_layers.encoder_layer{stage + 1}"
        for j in (0, 1):
            d = f"{dst}/SparseBasicBlock_{blk}"
            for n in (1, 2):
                c.conv(f"{layer}.{j}.conv{n}", f"{d}/SubMConv_{n - 1}", _spconv_w)
                c.bn(f"{layer}.{j}.bn{n}", f"{d}/MaskedBatchNorm_{n - 1}")
            blk += 1
        if stage < 3:  # the stage's strided downsample (conv 0, bn 1)
            c.conv(f"{layer}.2.0", f"{dst}/SparseConvDown_{stage}", _spconv_w)
            c.bn(f"{layer}.2.1", f"{dst}/MaskedBatchNorm_{stage + 1}")
    c.conv(f"{src}.conv_out.0", f"{dst}/SparseConvDown_3", _spconv_w)
    c.bn(f"{src}.conv_out.1", f"{dst}/MaskedBatchNorm_4")


def _second(c: _Ctx, src: str, dst: str) -> None:
    """decoder.backbone (mmdet3d SECOND: blocks.{b}, convs at 3j, BNs at
    3j + 1)."""
    sd, ci, b = c.sd, 0, 0
    while any(k.startswith(f"{src}.blocks.{b}.") for k in sd):
        n = sum(1 for k in sd if k.startswith(f"{src}.blocks.{b}.")
                and k.endswith(".weight") and sd[k].ndim == 4)
        for j in range(n):
            c.conv(f"{src}.blocks.{b}.{3 * j}", f"{dst}/Conv_{ci}", _bev_conv_w)
            c.bn(f"{src}.blocks.{b}.{3 * j + 1}", f"{dst}/BatchNorm2d_{ci}/BatchNorm_0")
            ci += 1
        b += 1
    if ci == 0:
        raise KeyError(f"no {src}.blocks.* keys")


def _secondfpn(c: _Ctx, src: str, dst: str) -> None:
    """decoder.neck (mmdet3d SECONDFPN): deblock i = (Conv | ConvTranspose,
    BN, ReLU); the stride-1 entries are 1x1 convs."""
    conv_i = convt_i = d = 0
    while f"{src}.deblocks.{d}.0.weight" in c.sd:
        if int(c.sd[f"{src}.deblocks.{d}.0.weight"].shape[2]) == 1:
            c.conv(f"{src}.deblocks.{d}.0", f"{dst}/Conv_{conv_i}", _bev_conv_w)
            conv_i += 1
        else:
            c.conv(f"{src}.deblocks.{d}.0", f"{dst}/ConvTranspose_{convt_i}", _bev_convT_w)
            convt_i += 1
        c.bn(f"{src}.deblocks.{d}.1", f"{dst}/BatchNorm2d_{d}/BatchNorm_0")
        d += 1
    if d == 0:
        raise KeyError(f"no {src}.deblocks.* keys")


def _transfusion_head(c: _Ctx, src: str, dst: str, heads: int) -> None:
    """heads.object (reference transfusion.py and utils/transformer.py)."""
    sd = c.sd
    c.conv(f"{src}.shared_conv", f"{dst}/shared_conv", _bev_conv_w)
    c.conv(f"{src}.heatmap_head.0.conv", f"{dst}/heatmap_conv", _bev_conv_w)
    c.bn(f"{src}.heatmap_head.0.bn", f"{dst}/heatmap_bn/BatchNorm_0")
    c.conv(f"{src}.heatmap_head.1", f"{dst}/heatmap_out", _bev_conv_w)
    c.params[f"{dst}/class_encoding/kernel"] = _c1d(sd[f"{src}.class_encoding.weight"])
    c.params[f"{dst}/class_encoding/bias"] = _f32(sd[f"{src}.class_encoding.bias"])
    for ours, theirs in (("self_posembed", "decoder.0.self_posembed"),
                         ("cross_posembed", "decoder.0.cross_posembed")):
        pe = f"{src}.{theirs}.position_embedding_head"
        c.params[f"{dst}/{ours}/fc1/kernel"] = _c1d(sd[f"{pe}.0.weight"])
        c.params[f"{dst}/{ours}/fc1/bias"] = _f32(sd[f"{pe}.0.bias"])
        c.bn(f"{pe}.1", f"{dst}/{ours}/bn/BatchNorm_0")
        c.params[f"{dst}/{ours}/fc2/kernel"] = _c1d(sd[f"{pe}.3.weight"])
        c.params[f"{dst}/{ours}/fc2/bias"] = _f32(sd[f"{pe}.3.bias"])
    dl, dd = f"{src}.decoder.0", f"{dst}/decoder0"
    c.attn(f"{dl}.self_attn", f"{dd}/MultiHeadDotProductAttention_0", heads)
    c.attn(f"{dl}.multihead_attn", f"{dd}/MultiHeadDotProductAttention_1", heads)
    for i in (0, 1):
        c.params[f"{dd}/Dense_{i}/kernel"] = _dense(sd[f"{dl}.linear{i + 1}.weight"])
        c.params[f"{dd}/Dense_{i}/bias"] = _f32(sd[f"{dl}.linear{i + 1}.bias"])
    for i in (1, 2, 3):
        c.params[f"{dd}/LayerNorm_{i - 1}/scale"] = _f32(sd[f"{dl}.norm{i}.weight"])
        c.params[f"{dd}/LayerNorm_{i - 1}/bias"] = _f32(sd[f"{dl}.norm{i}.bias"])
    for branch in ("center", "height", "dim", "rot", "vel", "heatmap"):
        ours, pb = f"{dst}/pred_{branch}", f"{src}.prediction_heads.0.{branch}"
        c.params[f"{ours}/conv0/kernel"] = _c1d(sd[f"{pb}.0.conv.weight"])
        c.bn(f"{pb}.0.bn", f"{ours}/bn0/BatchNorm_0")
        c.params[f"{ours}/out/kernel"] = _c1d(sd[f"{pb}.1.weight"])
        c.params[f"{ours}/out/bias"] = _f32(sd[f"{pb}.1.bias"])


def _lss_fpn(c: _Ctx, src: str, dst: str) -> None:
    """encoders.camera.neck (GeneralizedLSSFPN). flax creates the levels
    coarse to fine: Conv_{2m} is lateral_convs[L - 1 - m], Conv_{2m+1}
    fpn_convs[L - 1 - m]."""
    L = sum(1 for k in c.sd if k.startswith(f"{src}.lateral_convs.")
            and k.endswith(".conv.weight"))
    if L == 0:
        raise KeyError(f"no {src}.lateral_convs.* keys")
    for m in range(L):
        lvl = L - 1 - m
        c.conv(f"{src}.lateral_convs.{lvl}.conv", f"{dst}/Conv_{2 * m}", _img_conv_w)
        c.bn(f"{src}.lateral_convs.{lvl}.bn", f"{dst}/BatchNorm2d_{2 * m}/BatchNorm_0")
        c.conv(f"{src}.fpn_convs.{lvl}.conv", f"{dst}/Conv_{2 * m + 1}", _img_conv_w)
        c.bn(f"{src}.fpn_convs.{lvl}.bn", f"{dst}/BatchNorm2d_{2 * m + 1}/BatchNorm_0")


def _depth_lss(c: _Ctx, src: str, dst: str) -> None:
    """encoders.camera.vtransform (DepthLSSTransform): dtransform convs 0 / 3
    / 6 (BN 1 / 4 / 7), depthnet convs 0 / 3 (BN 1 / 4) and the 1x1 conv 6,
    the BEV downsample's convs 0 / 3 / 6 (BN 1 / 4 / 7)."""
    for i, t in enumerate((0, 3, 6)):
        c.conv(f"{src}.dtransform.{t}", f"{dst}/Conv_{i}", _img_conv_w)
        c.bn(f"{src}.dtransform.{t + 1}", f"{dst}/BatchNorm2d_{i}/BatchNorm_0")
    for i, t in enumerate((0, 3)):
        c.conv(f"{src}.depthnet.{t}", f"{dst}/Conv_{3 + i}", _img_conv_w)
        c.bn(f"{src}.depthnet.{t + 1}", f"{dst}/BatchNorm2d_{3 + i}/BatchNorm_0")
    c.conv(f"{src}.depthnet.6", f"{dst}/Conv_5", _img_conv_w)
    if f"{src}.downsample.0.weight" in c.sd:
        for i, t in enumerate((0, 3, 6)):
            c.conv(f"{src}.downsample.{t}", f"{dst}/Conv_{6 + i}", _bev_conv_w)
            c.bn(f"{src}.downsample.{t + 1}", f"{dst}/BatchNorm2d_{5 + i}/BatchNorm_0")


def reference_to_flax(state_dict: Dict[str, np.ndarray], num_heads: int = 8) -> dict:
    """A reference TransFusion-L or camera + lidar BEVFusion ``state_dict``
    (numpy arrays or tensors, ``module.`` prefixes allowed) -> ``{"params",
    "batch_stats"}`` with the JAX package's flat flax names. Raises KeyError
    for a missing key."""
    from .convert_swin import convert_swin_state_dict

    sd = {(k[len("module."):] if k.startswith("module.") else k): np.asarray(v)
          for k, v in state_dict.items()}
    c = _Ctx(sd)
    _sparse_encoder(c, "encoders.lidar.backbone", "SparseEncoder_0")
    _second(c, "decoder.backbone", "SECOND_0")
    _secondfpn(c, "decoder.neck", "SECONDFPN_0")
    _transfusion_head(c, "heads.object", "TransFusionHead_0", num_heads)
    if any(k.startswith("encoders.camera.") for k in sd):
        pre = "encoders.camera.backbone."
        swin = convert_swin_state_dict({k[len(pre):]: v for k, v in sd.items()
                                        if k.startswith(pre)})
        c.params.update({f"SwinTransformer_0/{k}": v for k, v in swin.items()})
        _lss_fpn(c, "encoders.camera.neck", "GeneralizedLSSFPN_0")
        _depth_lss(c, "encoders.camera.vtransform", "DepthLSSTransform_0")
        c.conv("fuser.0", "ConvFuser_0/Conv_0", _bev_conv_w)
        c.bn("fuser.1", "ConvFuser_0/BatchNorm2d_0/BatchNorm_0")
    return {"params": c.params, "batch_stats": c.stats}


def convert_bevfusion_state_dict(state_dict: Dict[str, np.ndarray],
                                 model) -> Dict[str, torch.Tensor]:
    """A reference BEVFusion ``state_dict`` -> the ``state_dict`` of the
    port's ``model`` (a BEVFusion, whose layers give the layout and the
    attention heads), through ``reference_to_flax`` and the weights
    bridge. Camera keys into a model without the camera branch raise
    KeyError, and so does a CenterPoint model, which has no place for the
    ``heads.object`` TransFusion tensors (JAX's ``apply_torch_init_bevfusion``
    refuses keys its tree lacks). The map-segmentation head's
    ``heads.map.*`` are not converted, as in JAX: a seg model keeps its own
    seg head."""
    camera = sorted(k for k in state_dict if k.split("module.", 1)[-1].startswith(
        ("encoders.camera.", "fuser.")))
    if camera and not model.with_camera:
        raise KeyError(f"camera keys in the checkpoint ({camera[0]}, ...): the model has no "
                       "camera branch")
    if model.head_type != "transfusion":
        raise KeyError(f"heads.object is a TransFusion head: the model's head is "
                       f"{model.head_type!r}")
    heads = model.head.decoder0.self_attn.heads
    return bevfusion_flax_to_state_dict(reference_to_flax(state_dict, heads), model)


def apply_torch_init_bevfusion(model, npz_path: str, logger=None):
    """Load a reference checkpoint converted by ``tools/convert_bevfusion.py``
    (an npz of the raw state_dict) into the port's BEVFusion in place: a
    converted tensor the model lacks raises KeyError, a shape mismatch
    ValueError (``models/convert_second.py::copy_converted``)."""
    conv = convert_bevfusion_state_dict(load_raw_state_dict_npz(npz_path), model)
    return copy_converted(model, conv, logger)
