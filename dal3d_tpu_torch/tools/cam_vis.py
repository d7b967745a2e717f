#!/usr/bin/env python
"""Camera-view visual debugging of the PyTorch port (port of JAX's
``tools/cam_vis.py``; the reference's tools/cam_vis.py): the GT boxes of
multi-view frames projected into each camera image, a grid PNG a frame.

    python -m dal3d_tpu_torch.tools.cam_vis CONFIG [--out_dir work_dirs/cam_vis]
        [--num 2] [--split train|val] [--cpu]

The config's pipeline must load camera images (a BEVFusion-style config).
``frame_views`` is the per-frame computation (host numpy: the images
un-normalised, the cameras and the GT boxes); the grid needs matplotlib
(on Agg), imported before any frame is read. Nothing runs on a device;
``--cpu`` is taken for JAX's flags' sake.
"""
import argparse
import os

import numpy as np

# ImageNormalize's mean and std, undone for display
MEAN = np.array([0.485, 0.456, 0.406])
STD = np.array([0.229, 0.224, 0.225])


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Project boxes into camera views")
    p.add_argument("config", help="a BEVFusion-style config with a camera pipeline")
    p.add_argument("--out_dir", default="work_dirs/cam_vis")
    p.add_argument("--num", type=int, default=2)
    p.add_argument("--split", default="train", choices=("train", "val"))
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def frame_views(cfg, args) -> list:
    """The first ``args.num`` frames of the split, one dict each: token,
    images [N, H, W, 3] in [0, 1], intrinsics [N, 3, 3], camera-to-lidar
    rotations [N, 3, 3] and translations [N, 3], gt_boxes [G, 9] or None."""
    from ..data import DataLoader, NuScenesDataset

    d = dict(cfg["data"][args.split])
    dataset = NuScenesDataset(
        info_path=d["info_path"], root_path=d.get("root_path", ""),
        nsweeps=d.get("nsweeps", 1), class_names=d.get("class_names"),
        pipeline=[dict(s) for s in d.get("pipeline", [])],
        tasks=[dict(t) for t in cfg["tasks"]],
        max_points=cfg.get("max_points", 300000),
        voxelize_host=dict(cfg["voxel_generator"]),
        test_mode=args.split == "val",
    )
    views = []
    for i, batch in enumerate(DataLoader(dataset, 1, shuffle=False)):
        if i >= args.num:
            break
        if "images" not in batch:
            raise SystemExit("config's pipeline produces no camera images")
        gt = None
        if "gt_boxes" in batch:
            g = np.concatenate([np.asarray(x[0]) for x in batch["gt_boxes"]])
            c = np.concatenate([np.asarray(x[0]) for x in batch["gt_classes"]])
            gt = g[c > 0]
        views.append(dict(
            token=batch["metadata"][0].get("token", str(i)),
            images=np.clip(np.asarray(batch["images"][0]) * STD + MEAN, 0, 1),
            intrinsics=np.asarray(batch["camera_intrinsics"][0]),
            rots=np.asarray(batch["camera2lidar_rots"][0]),
            trans=np.asarray(batch["camera2lidar_trans"][0]), gt_boxes=gt))
    return views


def main(argv=None) -> list:
    """Writes a PNG a frame and prints a line each; returns ``frame_views``."""
    from ..utils.config import Config
    from ..visualization.vis3d import GT_COLOR, _agg, draw_boxes_on_image

    args = parse_args(argv)
    plt = _agg()  # matplotlib is needed for every grid: fail before the frames
    cfg = Config.fromfile(args.config)
    os.makedirs(args.out_dir, exist_ok=True)
    views = frame_views(cfg, args)
    for i, v in enumerate(views):
        n = v["images"].shape[0]
        cols = min(n, 3)
        rows = -(-n // cols)
        fig, axes = plt.subplots(rows, cols, figsize=(6 * cols, 4 * rows), squeeze=False)
        for c in range(n):
            ax = axes[c // cols][c % cols]
            draw_boxes_on_image(ax, v["images"][c], v["gt_boxes"], v["intrinsics"][c],
                                v["rots"][c], v["trans"][c], color=GT_COLOR)
            ax.set_axis_off()
            ax.set_title(f"cam {c}")
        out = os.path.join(args.out_dir, f"{i:03d}_{v['token'][:8]}.png")
        fig.savefig(out, dpi=100, bbox_inches="tight")
        plt.close(fig)
        gt = v["gt_boxes"]
        print(f"frame {i}: {n} views, {0 if gt is None else len(gt)} gt -> {out}")
    return views


if __name__ == "__main__":
    main()
