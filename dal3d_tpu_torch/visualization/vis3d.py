"""3D, range-view, camera and heatmap plots (port of
``dal3d_tpu/visualization/vis3d.py``; the reference's det3d/visualization
viewers and tools/{lidar_visualize,cam_vis,debug_pred}.py as figures):
the geometry (box corners, the range image, the projection of boxes into a
camera) is host numpy; matplotlib (Agg) is imported when a figure is
drawn."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core import box_np_ops

GT_COLOR = "#2ca02c"
PRED_COLOR = "#d62728"


def _agg():
    """matplotlib.pyplot on the headless Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def boxes_to_corners_3d(boxes: np.ndarray) -> np.ndarray:
    """[N, >=7] (x, y, z, w, l, h, ..., yaw) -> [N, 8, 3] corners (z the
    centre)."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, boxes.shape[-1])
    return box_np_ops.center_to_corner_box3d(
        boxes[:, :3], boxes[:, 3:6], boxes[:, -1], origin=(0.5, 0.5, 0.5))


# the 12 wireframe edges of a box in corners_nd's corner order
_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
          (0, 4), (1, 5), (2, 6), (3, 7)]


def plot_3d_scene(points, gt_boxes=None, pred_boxes=None, max_points: int = 30000,
                  elev: float = 35.0, azim: float = -120.0, ax=None):
    """3D scatter of the points (at most ``max_points``, a seeded draw) with
    wireframe boxes."""
    plt = _agg()
    if ax is None:
        fig = plt.figure(figsize=(12, 9))
        ax = fig.add_subplot(111, projection="3d")
    pts = np.asarray(points)
    if len(pts) > max_points:
        pts = pts[np.random.RandomState(0).choice(len(pts), max_points, replace=False)]
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.15, c=pts[:, 2], cmap="viridis",
               linewidths=0)

    def draw(boxes, color):
        if boxes is None or len(np.atleast_2d(boxes)) == 0:
            return
        for c in boxes_to_corners_3d(boxes):
            for i, j in _EDGES:
                ax.plot(*zip(c[i], c[j]), color=color, linewidth=1.0)

    draw(gt_boxes, GT_COLOR)
    draw(pred_boxes, PRED_COLOR)
    ax.view_init(elev=elev, azim=azim)
    ax.set_box_aspect((1, 1, 0.25))
    return ax


def range_image(points: np.ndarray, h_fov=(-np.pi, np.pi), v_fov=(-0.5236, 0.1745),
                shape=(64, 1024)) -> np.ndarray:
    """Spherical range-view projection [H, W] of the points' ranges (0 =
    empty; the nearest return of a cell kept)."""
    pts = np.asarray(points, np.float64)
    r = np.linalg.norm(pts[:, :3], axis=1)
    az = np.arctan2(pts[:, 1], pts[:, 0])
    el = np.arcsin(np.divide(pts[:, 2], np.maximum(r, 1e-6)))
    H, W = shape
    col = ((az - h_fov[0]) / (h_fov[1] - h_fov[0]) * W).astype(int)
    row = ((v_fov[1] - el) / (v_fov[1] - v_fov[0]) * H).astype(int)
    ok = (col >= 0) & (col < W) & (row >= 0) & (row < H) & (r > 0)
    img = np.zeros(shape, np.float32)
    order = np.argsort(-r[ok])  # far first, so the nearest return is written last
    img[row[ok][order], col[ok][order]] = r[ok][order]
    return img


def plot_range_image(points, ax=None):
    plt = _agg()
    if ax is None:
        _, ax = plt.subplots(figsize=(14, 3))
    img = range_image(np.asarray(points))
    ax.imshow(np.where(img > 0, img, np.nan), cmap="turbo", aspect="auto")
    ax.set_axis_off()
    return ax


def project_boxes_to_image(boxes: np.ndarray, intrinsics: np.ndarray,
                           cam2lidar_rot: np.ndarray, cam2lidar_trans: np.ndarray):
    """Lidar-frame boxes -> (pixel corners [N, 8, 2], in front of the camera
    [N, 8]) for one camera given as intrinsics [3, 3] and its camera-to-lidar
    rotation and translation (p_lidar = R p_cam + t)."""
    corners = boxes_to_corners_3d(boxes)  # [N, 8, 3] lidar frame
    R = np.asarray(cam2lidar_rot, np.float64)
    t = np.asarray(cam2lidar_trans, np.float64)
    cam = (corners - t) @ R
    depth = cam[..., 2]
    uvw = cam @ np.asarray(intrinsics, np.float64).T
    uv = uvw[..., :2] / np.maximum(uvw[..., 2:3], 1e-6)
    return uv, depth > 0.1


def draw_boxes_on_image(ax, image: np.ndarray, boxes, intrinsics, cam2lidar_rot,
                        cam2lidar_trans, color=PRED_COLOR):
    """The image with the boxes whose corners all lie in front of the
    camera drawn as wireframes; the axes keep the image's extent."""
    img = np.asarray(image)
    ax.imshow(np.clip(img, 0, 1) if img.max() <= 4 else img.astype(np.uint8))
    H, W = img.shape[:2]
    if boxes is not None and len(np.atleast_2d(boxes)) > 0:
        uv, front = project_boxes_to_image(boxes, intrinsics, cam2lidar_rot, cam2lidar_trans)
        for corners, f in zip(uv, front):
            if not f.all():
                continue
            for i, j in _EDGES:
                ax.plot([corners[i, 0], corners[j, 0]], [corners[i, 1], corners[j, 1]],
                        color=color, linewidth=1.0)
    ax.set_xlim(-0.5, W - 0.5)
    ax.set_ylim(H - 0.5, -0.5)
    return ax


def plot_heatmap(hm: np.ndarray, ax=None, title: Optional[str] = None):
    """A dense BEV heatmap or segmentation channel."""
    plt = _agg()
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(np.asarray(hm), cmap="magma", origin="lower")
    if title:
        ax.set_title(title)
    ax.set_axis_off()
    return ax


def detection_gallery(path: str, frames: Sequence[dict], cols: int = 2,
                      pc_range=(-51.2, -51.2, 51.2, 51.2)):
    """A grid of BEV frames, each {points, gt_boxes?, pred_boxes?, title?},
    saved as a PNG; returns ``path``."""
    from .simplevis import bev_plot

    plt = _agg()
    n = len(frames)
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(7 * cols, 7 * rows), squeeze=False)
    for k, fr in enumerate(frames):
        ax = axes[k // cols][k % cols]
        bev_plot(fr["points"], fr.get("gt_boxes"), fr.get("pred_boxes"), pc_range=pc_range,
                 ax=ax)
        if fr.get("title"):
            ax.set_title(fr["title"])
    for k in range(n, rows * cols):
        axes[k // cols][k % cols].set_axis_off()
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return path


def save_scene(path: str, points, gt_boxes=None, pred_boxes=None, **kwargs):
    """``plot_3d_scene`` saved as a PNG at 110 dpi; returns ``path``."""
    plt = _agg()
    ax = plot_3d_scene(points, gt_boxes, pred_boxes, **kwargs)
    ax.figure.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(ax.figure)
    return path
