#!/usr/bin/env python
"""Offline lidar / detection visualiser of the PyTorch port (port of JAX's
``tools/lidar_visualize.py``; the reference's tools/lidar_visualize.py and
tools/debug_pred.py): frames of a config's dataset as BEV, 3D and (with
``--range_view``) range-view PNGs with the GT boxes and the detections, the
latter from a pkl of ``dist_test --out`` or predicted from a checkpoint.

    python -m dal3d_tpu_torch.tools.lidar_visualize CONFIG [--out_dir work_dirs/vis]
        [--num 4] [--split val|train] [--detections dets.pkl | --checkpoint WORK_DIR]
        [--score_thresh 0.3] [--range_view] [--cpu]

``--checkpoint`` loads a checkpoint of the port and predicts through
``runtime/steps.py::make_predict_step`` on the card (``--cpu``: the plain
versions on the CPU), fed the loader's host voxels, or its raw points when
the batch has none. ``frame_records`` is the per-frame computation; the
figures need matplotlib (on Agg), imported before any frame is read.
"""
import argparse
import os
import pickle

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Visualize lidar frames + detections")
    p.add_argument("config")
    p.add_argument("--out_dir", default="work_dirs/vis")
    p.add_argument("--num", type=int, default=4, help="number of frames")
    p.add_argument("--split", default="val", choices=("train", "val"))
    p.add_argument("--detections", help="pkl of detections (dist_test --out)")
    p.add_argument("--checkpoint", help="run predict live from this work_dir")
    p.add_argument("--score_thresh", type=float, default=0.3)
    p.add_argument("--range_view", action="store_true", help="also render range images")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (plain kernel versions)")
    return p.parse_args(argv)


def build_dataset(cfg, split: str):
    """The config's ``data.<split>`` dataset as JAX's CLI builds it (test
    mode for ``val``; host voxels unless ``voxelize_host = False``)."""
    from ..data import NuScenesDataset
    from ..models.builder import loader_voxelize_cfg

    d = dict(cfg["data"][split])
    return NuScenesDataset(
        info_path=d["info_path"], root_path=d.get("root_path", ""),
        nsweeps=d.get("nsweeps", 10), class_names=d.get("class_names"),
        pipeline=[dict(s) for s in d.get("pipeline", [])],
        tasks=[dict(t) for t in cfg["tasks"]],
        max_points=cfg.get("max_points", 300000),
        voxelize_host=loader_voxelize_cfg(cfg),
        test_mode=split == "val",
    )


def frame_records(cfg, args, device) -> list:
    """The first ``args.num`` frames of the split, one dict each: token,
    points [N, F] (the valid ones), gt_boxes [G, 9] or None, pred_boxes
    [D, 9] or None (the detections of ``args.detections`` for the frame's
    token, else, with ``args.checkpoint``, the predicted ones; those valid
    and scoring at least ``args.score_thresh``)."""
    from ..data import DataLoader

    dataset = build_dataset(cfg, args.split)
    detections = {}
    if args.detections:
        with open(args.detections, "rb") as f:
            detections = pickle.load(f)
    predict = None
    if args.checkpoint:
        from ..models.builder import build_detector
        from ..runtime import checkpoint as ckpt
        from ..runtime.steps import make_predict_step

        bundle = build_detector(cfg, device=device)
        ckpt.load_checkpoint(args.checkpoint, bundle.model)
        predict = make_predict_step(bundle)
    records = []
    for i, batch in enumerate(DataLoader(dataset, 1, shuffle=False)):
        if i >= args.num:
            break
        pts = np.asarray(batch["points"][0])[np.asarray(batch["points_valid"][0])]
        token = batch["metadata"][0].get("token", str(i))
        gt = None
        if "gt_boxes" in batch:
            gt = np.concatenate([np.asarray(g[0]) for g in batch["gt_boxes"]])
            cls = np.concatenate([np.asarray(c[0]) for c in batch["gt_classes"]])
            gt = gt[cls > 0]
        pred = None
        det = detections.get(token)
        if det is None and predict is not None:
            out = predict(batch)
            det = {k: out[k][0].cpu().numpy() for k in ("box3d_lidar", "scores", "det_valid")}
        if det is not None:
            keep = np.asarray(det["det_valid"]).astype(bool) & (
                np.asarray(det["scores"]) >= args.score_thresh)
            pred = np.asarray(det["box3d_lidar"])[keep]
        records.append(dict(token=token, points=pts, gt_boxes=gt, pred_boxes=pred))
    return records


def main(argv=None) -> list:
    """Writes the PNGs and prints a line a frame; returns ``frame_records``."""
    from ..device import resolve_device
    from ..utils.config import Config
    from ..visualization import detection_gallery, save_bev, save_scene
    from ..visualization.vis3d import _agg, plot_range_image

    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    plt = _agg()  # matplotlib is needed for every figure: fail before the frames
    cfg = Config.fromfile(args.config)
    os.makedirs(args.out_dir, exist_ok=True)
    rng_cfg = cfg["voxel_generator"]["range"]
    pc_range = (rng_cfg[0], rng_cfg[1], rng_cfg[3], rng_cfg[4])
    records = frame_records(cfg, args, device)
    gallery = []
    for i, r in enumerate(records):
        pts, gt, pred, token = r["points"], r["gt_boxes"], r["pred_boxes"], r["token"]
        save_bev(os.path.join(args.out_dir, f"{i:03d}_{token[:8]}_bev.png"),
                 pts, gt, pred, pc_range=pc_range)
        save_scene(os.path.join(args.out_dir, f"{i:03d}_{token[:8]}_3d.png"), pts, gt, pred)
        if args.range_view:
            ax = plot_range_image(pts)
            ax.figure.savefig(os.path.join(args.out_dir, f"{i:03d}_{token[:8]}_range.png"),
                              dpi=110, bbox_inches="tight")
            plt.close(ax.figure)
        gallery.append({"points": pts, "gt_boxes": gt, "pred_boxes": pred,
                        "title": token[:16]})
        print(f"frame {i} ({token[:16]}): {len(pts)} pts, "
              f"{0 if gt is None else len(gt)} gt, "
              f"{0 if pred is None else len(pred)} dets")
    if gallery:
        detection_gallery(os.path.join(args.out_dir, "gallery.png"), gallery,
                          pc_range=pc_range)
    print(f"wrote {args.out_dir} ({len(gallery)} frames)")
    return records


if __name__ == "__main__":
    main()
