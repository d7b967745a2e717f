"""Device-side 3D box geometry in torch (port of the decode half of
``dal3d_tpu/core/box_ops_jax.py``)."""
from __future__ import annotations

import torch


def second_box_decode(box_encodings: torch.Tensor, anchors: torch.Tensor,
                      encode_angle_to_vector: bool = False,
                      smooth_dim: bool = False) -> torch.Tensor:
    """Residual decode of [..., code] encodings against [..., 7|9] anchors."""
    ndim = anchors.shape[-1]
    xa, ya, za, wa, la, ha = (anchors[..., i] for i in range(6))
    ra = anchors[..., -1]
    xt, yt, zt, wt, lt, ht = (box_encodings[..., i] for i in range(6))

    diagonal = torch.sqrt(la ** 2 + wa ** 2)
    xg = xt * diagonal + xa
    yg = yt * diagonal + ya
    zg = zt * ha + za
    if smooth_dim:
        lg, wg, hg = (lt + 1) * la, (wt + 1) * wa, (ht + 1) * ha
    else:
        lg, wg, hg = torch.exp(lt) * la, torch.exp(wt) * wa, torch.exp(ht) * ha
    ret = [xg, yg, zg, wg, lg, hg]
    if ndim > 7:
        ret.append(box_encodings[..., 6] + anchors[..., 6])
        ret.append(box_encodings[..., 7] + anchors[..., 7])
        ang = box_encodings[..., 8:]
    else:
        ang = box_encodings[..., 6:]
    if encode_angle_to_vector:
        rg = torch.atan2(ang[..., 1] + torch.sin(ra), ang[..., 0] + torch.cos(ra))
    else:
        rg = ang[..., 0] + ra
    ret.append(rg)
    return torch.stack(ret, dim=-1)


def corners_2d(boxes_bev: torch.Tensor) -> torch.Tensor:
    """Rotated BEV boxes [..., 5] (x, y, w, l, r) -> corners [..., 4, 2],
    counterclockwise as in ``box_np_ops.center_to_corner_box2d``."""
    x, y, w, l, r = (boxes_bev[..., i] for i in range(5))
    dx = torch.stack([-w / 2, -w / 2, w / 2, w / 2], dim=-1)
    dy = torch.stack([-l / 2, l / 2, l / 2, -l / 2], dim=-1)
    cos, sin = torch.cos(r)[..., None], torch.sin(r)[..., None]
    cx = dx * cos + dy * sin
    cy = -dx * sin + dy * cos
    return torch.stack([cx + x[..., None], cy + y[..., None]], dim=-1)
