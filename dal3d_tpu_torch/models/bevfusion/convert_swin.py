"""Torch Swin checkpoint -> the flax names of the JAX package's
``SwinTransformer`` (port of ``dal3d_tpu/models/bevfusion/convert_swin.py``),
and from there into the port's camera backbone.

The reference's camera branch warm-starts from the pretrained
``swint-nuimages`` checkpoint. Either naming scheme is read:
- microsoft / timm: ``patch_embed.proj``, ``layers.{i}.blocks.{j}.attn.qkv``,
  ``layers.{i}.downsample.reduction``, ``norm{i}``;
- mmdet / mmcv: a ``backbone.`` prefix, ``stages.``, ``attn.w_msa.``,
  ``ffn.layers.0.0`` / ``ffn.layers.1``, ``patch_embed.projection``.

Layouts: conv kernels [out, in, kh, kw] -> [kh, kw, in, out]; dense kernels
[out, in] -> [in, out]; the patch merge's 4C input groups reordered from the
reference's column-major 2x2 order [(0,0), (1,0), (0,1), (1,1)] to the
row-major one of the JAX module (group permutation (0, 2, 1, 3) on the
reduction weight's input and on the norm before it). The relative position
bias tables carry over as they are.

``convert_swin_state_dict`` returns the flat ``Conv_0/kernel``-style names
that ``tools/convert_swin.py`` writes to an npz (the JAX tool's format, so
either package reads it); ``load_swin_npz`` loads such an npz into the port's
``SwinTransformer`` through the weights bridge.
"""
from __future__ import annotations

import re
from typing import Dict, Sequence

import numpy as np
import torch

_MERGE_PERM = (0, 2, 1, 3)  # the reference's 2x2-group index of each of our group slots


def _normalize(name: str) -> str:
    name = re.sub(r"^(backbone|module)\.", "", name)
    name = name.replace("patch_embed.projection", "patch_embed.proj")
    name = re.sub(r"^stages\.", "layers.", name)
    name = name.replace(".attn.w_msa.", ".attn.")
    name = name.replace(".ffn.layers.0.0.", ".mlp.fc1.")
    return name.replace(".ffn.layers.1.", ".mlp.fc2.")


def _dense(w):  # torch [out, in] -> flax [in, out]
    return np.ascontiguousarray(np.asarray(w, np.float32).T)


def _merge_groups(w4c: np.ndarray, axis: int) -> np.ndarray:
    """The 4 C-sized groups along ``axis`` from the reference's order to ours."""
    g = np.split(np.asarray(w4c, np.float32), 4, axis=axis)
    return np.concatenate([g[p] for p in _MERGE_PERM], axis=axis)


def convert_swin_state_dict(sd: Dict[str, np.ndarray], depths: Sequence[int] = (2, 2, 6, 2),
                            out_indices: Sequence[int] = (1, 2, 3)) -> Dict[str, np.ndarray]:
    """A torch Swin ``state_dict`` (numpy arrays) -> flat flax-named f32
    params of ``SwinTransformer`` (``Conv_0/kernel``, ``SwinBlock_3/...``).
    Raises KeyError for a missing tensor."""
    sd = {_normalize(k): np.asarray(v, np.float32) for k, v in sd.items()
          if "relative_position_index" not in k and "attn_mask" not in k}
    p: Dict[str, np.ndarray] = {
        "Conv_0/kernel": np.ascontiguousarray(sd["patch_embed.proj.weight"].transpose(2, 3, 1, 0)),
        "Conv_0/bias": sd["patch_embed.proj.bias"],
        "LayerNorm_0/scale": sd["patch_embed.norm.weight"],
        "LayerNorm_0/bias": sd["patch_embed.norm.bias"],
    }
    blk, out_norm = 0, 1  # LayerNorm_{1..} are the output stages' norms, in order
    for i, depth in enumerate(depths):
        for j in range(depth):
            t, f = f"layers.{i}.blocks.{j}.", f"SwinBlock_{blk}/"
            p[f + "LayerNorm_0/scale"] = sd[t + "norm1.weight"]
            p[f + "LayerNorm_0/bias"] = sd[t + "norm1.bias"]
            p[f + "WindowAttention_0/Dense_0/kernel"] = _dense(sd[t + "attn.qkv.weight"])
            p[f + "WindowAttention_0/Dense_0/bias"] = sd[t + "attn.qkv.bias"]
            p[f + "WindowAttention_0/relative_position_bias_table"] = sd[
                t + "attn.relative_position_bias_table"]
            p[f + "WindowAttention_0/Dense_1/kernel"] = _dense(sd[t + "attn.proj.weight"])
            p[f + "WindowAttention_0/Dense_1/bias"] = sd[t + "attn.proj.bias"]
            p[f + "LayerNorm_1/scale"] = sd[t + "norm2.weight"]
            p[f + "LayerNorm_1/bias"] = sd[t + "norm2.bias"]
            p[f + "Dense_0/kernel"] = _dense(sd[t + "mlp.fc1.weight"])
            p[f + "Dense_0/bias"] = sd[t + "mlp.fc1.bias"]
            p[f + "Dense_1/kernel"] = _dense(sd[t + "mlp.fc2.weight"])
            p[f + "Dense_1/bias"] = sd[t + "mlp.fc2.bias"]
            blk += 1
        # the downsample at the end of the reference's layer i is our
        # PatchMerging_{i} (before stage i + 1); the last stage has none
        dt = f"layers.{i}.downsample."
        if dt + "reduction.weight" in sd:
            p[f"PatchMerging_{i}/LayerNorm_0/scale"] = _merge_groups(sd[dt + "norm.weight"], 0)
            p[f"PatchMerging_{i}/LayerNorm_0/bias"] = _merge_groups(sd[dt + "norm.bias"], 0)
            p[f"PatchMerging_{i}/Dense_0/kernel"] = _dense(
                _merge_groups(sd[dt + "reduction.weight"], 1))
        if i in out_indices:
            p[f"LayerNorm_{out_norm}/scale"] = sd[f"norm{i}.weight"]
            p[f"LayerNorm_{out_norm}/bias"] = sd[f"norm{i}.bias"]
            out_norm += 1
    return p


def load_swin_npz(swin, path: str) -> int:
    """Load an npz of ``tools/convert_swin.py`` (flat flax names) into the
    port's ``SwinTransformer`` ``swin`` in place. Every parameter must be
    covered and every array used (a converted tree of other depths or output
    stages raises, as the JAX CLI's tree check does). Returns the tensors
    loaded."""
    from ..convert_flax import swin_flax_to_state_dict

    flat = {k: np.asarray(v, np.float32) for k, v in np.load(path).items()}
    sd = swin_flax_to_state_dict(flat, swin)
    if len(sd) != len(flat):
        raise KeyError(f"{path}: {len(flat)} arrays, of which the model reads {len(sd)} (check "
                       "depths / out_indices)")
    own = swin.state_dict()
    for k, v in sd.items():
        if k not in own or tuple(own[k].shape) != v.shape:
            raise ValueError(f"{path}: {k} {v.shape} does not fit the model "
                             f"({tuple(own[k].shape) if k in own else 'missing'})")
    swin.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                         strict=True)
    return len(sd)
