"""det3d CBGS VoxelNet checkpoint -> the port's FPNVoxelNet ``state_dict``
(the port's own copy of ``dal3d_tpu/models/convert_second.py``'s mapping,
written straight to torch names with no flax tree in between).

The reference trains det3d's VoxelNet (parameter-free mean VFE,
FPNSpMiddleResNetFHD backbone, RPN neck, MultiGroupHead) and saves it with
torchie's ``save_checkpoint``: a plain ``state_dict``, possibly under a
``state_dict`` key, its keys prefixed ``module.`` under DDP.

Layouts:
  - spconv kernels [kd, kh, kw, Cin, Cout] -> the port's [kd*kh*kw, Cin,
    Cout], taps z-major, the order both sparse engines walk. The banded and
    the gather backbone share their names, so one converted state dict
    loads into either (JAX's ``convert_second_state_dict`` writes L0 under
    ``l0`` or inlined, ``nested_l0``, for its two flax layouts);
  - torch Conv2d / ConvTranspose2d weights and BN keep torch's layout: only
    the names change;
  - backbone: ``middle_conv0`` (stem 0, BN 1, blocks 3 / 4, strided conv 5,
    BN 6) -> ``backbone.l0``; ``middle_conv{1..3}`` (blocks 0 / 1, strided
    conv 2, BN 3) -> ``backbone.stage{1..3}``. A non-FPN checkpoint
    (``SpMiddleResNetFHD``: one ``middle_conv`` Sequential, its L0 at the
    same indices, its stages at 8 / 9, 10, 11 | 13 / 14, 15, 16 | 18 / 19,
    20, 21) maps onto the same names, as JAX's converter reads it;
  - neck: ``neck.blocks.{b}.{1 + 3j}`` (after the ZeroPad) and its BN at
    ``{2 + 3j}`` -> ``neck.blocks.{b}.{j}`` with ``.bn``;
    ``neck.deblocks.{d}.0`` / ``.1`` -> ``neck.deblocks.{d}`` with ``.bn``;
  - head: ``bbox_head.tasks.{t}.conv_box`` / ``conv_cls`` -> ``head.tasks.{t}``.

``tools/convert_second.py`` writes the raw ``state_dict`` as an npz
(``save_raw_state_dict_npz``); ``--torch_init`` maps it at load time
(``apply_torch_init``)."""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

STAGES = 3


def _strip(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Unwrap DDP's ``module.`` prefix."""
    if any(k.startswith("module.") for k in sd):
        return {k[len("module."):]: v for k, v in sd.items() if k.startswith("module.")}
    return dict(sd)


def _spconv(w) -> np.ndarray:
    """[kd, kh, kw, Cin, Cout] -> [kd*kh*kw, Cin, Cout] (z-major taps)."""
    w = np.asarray(w, np.float32)
    kd, kh, kw, ci, co = w.shape
    return w.reshape(kd * kh * kw, ci, co)


def _bn(sd, src: str, dst: str, out: dict) -> None:
    for name in ("weight", "bias", "running_mean", "running_var"):
        out[f"{dst}.{name}"] = np.asarray(sd[f"{src}.{name}"], np.float32)


def _block(sd, src: str, dst: str, out: dict) -> None:
    """SparseBasicBlock: conv1 / bn1 / conv2 / bn2, conv biases."""
    for j in (1, 2):
        out[f"{dst}.conv{j}.weight"] = _spconv(sd[f"{src}.conv{j}.weight"])
        out[f"{dst}.conv{j}.bias"] = np.asarray(sd[f"{src}.conv{j}.bias"], np.float32)
        _bn(sd, f"{src}.bn{j}", f"{dst}.bn{j}", out)


def convert_second_state_dict(state_dict: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A det3d CBGS VoxelNet ``state_dict`` (numpy or torch values; the FPN
    or the non-FPN backbone) -> the port's FPNVoxelNet ``state_dict`` (f32
    CPU tensors). Raises KeyError on a layout it does not know."""
    sd = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
          for k, v in _strip(state_dict).items()}
    out: Dict[str, np.ndarray] = {}

    if any(k.startswith("backbone.middle_conv0.") for k in sd):
        l0 = "backbone.middle_conv0"
        stages = [(f"backbone.middle_conv{s}.0", f"backbone.middle_conv{s}.1",
                   f"backbone.middle_conv{s}.2", f"backbone.middle_conv{s}.3")
                  for s in range(1, STAGES + 1)]
    elif any(k.startswith("backbone.middle_conv.") for k in sd):
        l0 = "backbone.middle_conv"
        stages = [tuple(f"{l0}.{i + j}" for j in range(4)) for i in (8, 13, 18)]
    else:
        raise KeyError("no backbone.middle_conv0.* (FPN) or backbone.middle_conv.* keys in "
                       "state_dict")
    out["backbone.l0.stem.weight"] = _spconv(sd[f"{l0}.0.weight"])
    _bn(sd, f"{l0}.1", "backbone.l0.stem_bn", out)
    _block(sd, f"{l0}.3", "backbone.l0.block0", out)
    _block(sd, f"{l0}.4", "backbone.l0.block1", out)
    out["backbone.l0.down.weight"] = _spconv(sd[f"{l0}.5.weight"])
    _bn(sd, f"{l0}.6", "backbone.l0.down_bn", out)
    for s, (b0, b1, down, bn) in enumerate(stages, start=1):
        dst = f"backbone.stage{s}"
        _block(sd, b0, f"{dst}.block0", out)
        _block(sd, b1, f"{dst}.block1", out)
        out[f"{dst}.down.weight"] = _spconv(sd[f"{down}.weight"])
        _bn(sd, bn, f"{dst}.down_bn", out)

    # neck: block b = Sequential(ZeroPad, then (Conv, BN, ReLU) x layers)
    b = 0
    while any(k.startswith(f"neck.blocks.{b}.") for k in sd):
        j = 0
        while f"neck.blocks.{b}.{1 + 3 * j}.weight" in sd:
            out[f"neck.blocks.{b}.{j}.weight"] = np.asarray(
                sd[f"neck.blocks.{b}.{1 + 3 * j}.weight"], np.float32)
            _bn(sd, f"neck.blocks.{b}.{2 + 3 * j}", f"neck.blocks.{b}.{j}.bn", out)
            j += 1
        b += 1
    if b == 0:
        raise KeyError("no neck.blocks.* keys in state_dict")
    d = 0
    while f"neck.deblocks.{d}.0.weight" in sd:
        out[f"neck.deblocks.{d}.weight"] = np.asarray(sd[f"neck.deblocks.{d}.0.weight"],
                                                     np.float32)
        _bn(sd, f"neck.deblocks.{d}.1", f"neck.deblocks.{d}.bn", out)
        d += 1

    t = 0
    while f"bbox_head.tasks.{t}.conv_box.weight" in sd:
        for conv in ("conv_box", "conv_cls"):
            for p in ("weight", "bias"):
                out[f"head.tasks.{t}.{conv}.{p}"] = np.asarray(
                    sd[f"bbox_head.tasks.{t}.{conv}.{p}"], np.float32)
        t += 1
    if t == 0:
        raise KeyError("no bbox_head.tasks.*.conv_box keys in state_dict")
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


_TO_DET3D = (  # (port name pattern, det3d name), the inverse of the map above
    (r"backbone\.l0\.stem\.", "backbone.middle_conv0.0."),
    (r"backbone\.l0\.stem_bn\.", "backbone.middle_conv0.1."),
    (r"backbone\.l0\.block(\d)\.", lambda m: f"backbone.middle_conv0.{3 + int(m[1])}."),
    (r"backbone\.l0\.down\.", "backbone.middle_conv0.5."),
    (r"backbone\.l0\.down_bn\.", "backbone.middle_conv0.6."),
    (r"backbone\.stage(\d)\.block(\d)\.", lambda m: f"backbone.middle_conv{m[1]}.{m[2]}."),
    (r"backbone\.stage(\d)\.down\.", lambda m: f"backbone.middle_conv{m[1]}.2."),
    (r"backbone\.stage(\d)\.down_bn\.", lambda m: f"backbone.middle_conv{m[1]}.3."),
    (r"neck\.blocks\.(\d+)\.(\d+)\.bn\.",
     lambda m: f"neck.blocks.{m[1]}.{2 + 3 * int(m[2])}."),
    (r"neck\.blocks\.(\d+)\.(\d+)\.", lambda m: f"neck.blocks.{m[1]}.{1 + 3 * int(m[2])}."),
    (r"neck\.deblocks\.(\d+)\.bn\.", lambda m: f"neck.deblocks.{m[1]}.1."),
    (r"neck\.deblocks\.(\d+)\.", lambda m: f"neck.deblocks.{m[1]}.0."),
    (r"head\.", "bbox_head."),
)


def to_det3d_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's FPNVoxelNet ``state_dict`` -> det3d names and layouts (the
    inverse of ``convert_second_state_dict``; spconv kernels of 27 taps
    become [3, 3, 3, Cin, Cout], of 3 taps [3, 1, 1, Cin, Cout]): writes the
    port's weights as a reference checkpoint."""
    out = {}
    for k, v in state_dict.items():
        for pat, rep in _TO_DET3D:
            m = re.match(pat, k)
            if m:
                name = (rep(m) if callable(rep) else rep) + k[m.end():]
                break
        else:
            raise KeyError(f"{k}: not a tensor of the port's FPNVoxelNet")
        v = v.detach().cpu().float().numpy()
        if k.startswith("backbone.") and k.endswith(".weight") and v.ndim == 3:
            v = v.reshape({27: (3, 3, 3), 3: (3, 1, 1)}[v.shape[0]] + v.shape[1:])
        out[name] = v
    return out


def save_raw_state_dict_npz(sd: Dict[str, np.ndarray], path: str) -> None:
    """Write a raw torch ``state_dict`` as npz (npz keys may not hold dots:
    '.' is escaped, and ``load_raw_state_dict_npz`` un-escapes it). The same
    file format as JAX's, so either package reads the other's."""
    np.savez(path, **{k.replace(".", "__dot__"): np.asarray(v) for k, v in sd.items()})


def load_raw_state_dict_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as flat:
        return {k.replace("__dot__", "."): flat[k] for k in flat.files}


def apply_torch_init(model: torch.nn.Module, npz_path: str, logger=None) -> torch.nn.Module:
    """Load a converted reference checkpoint (an npz of
    ``tools/convert_second.py``) into ``model`` (an FPNVoxelNet) in place
    (``copy_converted``)."""
    return copy_converted(model, convert_second_state_dict(load_raw_state_dict_npz(npz_path)),
                          logger)


def copy_converted(model: torch.nn.Module, conv: Dict[str, torch.Tensor],
                   logger=None) -> torch.nn.Module:
    """Copy converted tensors into ``model`` in place. Every converted tensor
    must name a tensor of the model (KeyError) of the same shape
    (ValueError); the model's tensors the checkpoint does not cover keep
    their values and are logged."""
    own = model.state_dict()
    unknown = sorted(set(conv) - set(own))
    if unknown:
        raise KeyError(f"converted keys not in the model: {unknown[:5]}"
                       f" (+{max(len(unknown) - 5, 0)} more)")
    for k, v in conv.items():
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(f"shape mismatch at {k}: model {tuple(own[k].shape)} vs "
                             f"checkpoint {tuple(v.shape)}")
    missing = sorted(set(own) - set(conv))
    if missing and logger is not None:
        logger.info(f"torch_init: {len(missing)} model tensors not in the checkpoint keep "
                    f"their values (e.g. {missing[0]})")
    with torch.no_grad():
        for k, v in conv.items():
            own[k].copy_(v.to(own[k].dtype))
    return model
