"""Residual ground-box coder (port of ``dal3d_tpu/core/box_coders.py``). ``GroundBox3dCoder(n_dim=9,
vec_encode=True)`` gives the CBGS code size 10."""
from __future__ import annotations

from . import box_ops


class GroundBox3dCoder:
    def __init__(self, vec_encode: bool = False, linear_dim: bool = False,
                 n_dim: int = 7, **kwargs):
        self.linear_dim = linear_dim
        self.vec_encode = vec_encode
        self.n_dim = n_dim

    @property
    def code_size(self) -> int:
        return self.n_dim + 1 if self.vec_encode else self.n_dim

    def encode(self, boxes, anchors):
        return box_ops.second_box_encode(
            boxes, anchors, encode_angle_to_vector=self.vec_encode,
            smooth_dim=self.linear_dim)

    def decode(self, encodings, anchors):
        return box_ops.second_box_decode(
            encodings, anchors, encode_angle_to_vector=self.vec_encode,
            smooth_dim=self.linear_dim)


def build_box_coder(cfg: dict) -> GroundBox3dCoder:
    cfg = dict(cfg)
    coder_type = cfg.pop("type")
    if coder_type in ("ground_box3d_coder", "GroundBox3dCoder"):
        return GroundBox3dCoder(
            vec_encode=cfg.get("encode_angle_vector", False),
            linear_dim=cfg.get("linear_dim", False),
            n_dim=cfg.get("n_dim", 7),
        )
    raise ValueError(f"unknown box coder: {coder_type}")
