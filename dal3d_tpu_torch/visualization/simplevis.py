"""BEV point-cloud and box plots (port of
``dal3d_tpu/visualization/simplevis.py``; the reference's
det3d/visualization/simplevis.py): the cloud as a BEV scatter with GT
(green) and predicted (red) rotated boxes. Host numpy; matplotlib (Agg) is
imported when a plot is drawn."""
from __future__ import annotations

import numpy as np

from ..core import box_np_ops


def bev_plot(points, gt_boxes=None, pred_boxes=None, pc_range=(-51.2, -51.2, 51.2, 51.2),
             point_size: float = 0.1, ax=None):
    """points [N, >=2], boxes [M, >=7] (x, y, z, w, l, h, ..., yaw) -> the
    matplotlib axes drawn on (a new 10 x 10 in figure unless ``ax``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(10, 10))
    pts = np.asarray(points)
    ax.scatter(pts[:, 0], pts[:, 1], s=point_size, c="#888888", linewidths=0)

    def draw(boxes, color):
        boxes = np.asarray(boxes).reshape(-1, boxes.shape[-1])
        if len(boxes) == 0:
            return
        bev = boxes[:, [0, 1, 3, 4, boxes.shape[-1] - 1]]
        corners = box_np_ops.center_to_corner_box2d(bev[:, :2], bev[:, 2:4], bev[:, 4])
        for c in corners:
            poly = np.vstack([c, c[:1]])
            ax.plot(poly[:, 0], poly[:, 1], color=color, linewidth=1.0)

    if gt_boxes is not None:
        draw(gt_boxes, "#2ca02c")
    if pred_boxes is not None:
        draw(pred_boxes, "#d62728")
    ax.set_xlim(pc_range[0], pc_range[2])
    ax.set_ylim(pc_range[1], pc_range[3])
    ax.set_aspect("equal")
    return ax


def save_bev(path: str, points, gt_boxes=None, pred_boxes=None, **kwargs):
    """``bev_plot`` saved as a PNG at 120 dpi; returns ``path``."""
    import matplotlib.pyplot as plt

    ax = bev_plot(points, gt_boxes, pred_boxes, **kwargs)
    ax.figure.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(ax.figure)
    return path
