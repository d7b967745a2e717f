#!/usr/bin/env python
"""Detections of the pool -> ``pred_list.pkl`` (the port of the JAX package's
``tools/ppal_pred_list.py``; read by ``tools/ppal_unc.py``).

    python -m dal3d_tpu_torch.tools.ppal_pred_list CONFIG --checkpoint WORK_DIR [--out pred_list.pkl]

The pool (``--info_path``, by default the selector's ``infos_origin``) goes
through the config's val pipeline as raw points (no host voxels), and the
predict step voxelizes them on the device. ``--augment`` flips the points in
y first and the detected boxes back (CALD's consistency augmentation; see
``tools/cald_pred_list.py``, which has the same body). One detection dict per
frame token, host arrays; the padded repeats of the last batch are skipped.
It runs on the CUDA card; ``--cpu`` is the only way onto the CPU.
"""
import argparse
import pickle

import numpy as np

DET_KEYS = ("box3d_lidar", "scores", "label_preds", "det_valid")


def parse_args(argv=None, default_out="pred_list.pkl"):
    p = argparse.ArgumentParser(description="Dump the pool's detections")
    p.add_argument("config")
    p.add_argument("--checkpoint", required=True, help="trained checkpoint work_dir")
    p.add_argument("--out", default=default_out)
    p.add_argument("--info_path", default=None, help="pool infos (default: selector.infos_origin)")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (plain kernel versions)")
    p.add_argument("--augment", action="store_true",
                   help="apply the CALD test-time flip augmentation before scoring")
    return p.parse_args(argv)


def flip_back(det: dict) -> dict:
    """Boxes detected on y-flipped points, in the original frame: y, the y
    velocity and the yaw (-yaw + pi) flip back."""
    box = det["box3d_lidar"].copy()
    box[:, 1] *= -1
    box[:, 7] *= -1
    box[:, 8] = -box[:, 8] + np.pi
    return dict(det, box3d_lidar=box)


def predict_pool(args) -> dict:
    """The body of both prediction-list CLIs: token -> detections."""
    from ..device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)  # raises here without a GPU
    import torch

    from ..data import DataLoader, NuScenesDataset
    from ..models.builder import build_detector
    from ..runtime import checkpoint as ckpt
    from ..runtime.steps import make_predict_step
    from ..utils.config import Config
    from ..utils.log import get_root_logger

    cfg = Config.fromfile(args.config)
    logger = get_root_logger(None, cfg.get("log_level", "INFO"))
    bundle = build_detector(cfg, device=device)
    val = dict(cfg["data"]["val"])
    dataset = NuScenesDataset(
        info_path=args.info_path or dict(cfg["selector"])["infos_origin"],
        root_path=val.get("root_path", ""), nsweeps=val.get("nsweeps", 10),
        class_names=val.get("class_names"), pipeline=[dict(s) for s in val.get("pipeline", [])],
        tasks=[dict(t) for t in cfg["tasks"]], max_points=cfg.get("max_points", 300000),
        voxelize_host=None,  # the predict step voxelizes the (possibly flipped) points
        test_mode=True,
    )
    batch_size = args.batch_size or cfg["data"].get("samples_per_gpu", 2)
    loader = DataLoader(dataset, batch_size, shuffle=False, drop_last=False)
    _, meta = ckpt.load_checkpoint(args.checkpoint, bundle.model)
    logger.info(f"loaded checkpoint epoch {meta.get('epoch')}")
    predict = make_predict_step(bundle)

    preds = {}
    for batch in loader:
        pts = torch.as_tensor(batch["points"]).to(device)
        if args.augment:  # CALD consistency augmentation: y-flip
            pts = pts * torch.tensor([1.0, -1.0] + [1.0] * (pts.shape[-1] - 2), device=device)
        out = predict({"points": pts, "points_valid": batch["points_valid"]})
        out = {k: out[k].cpu().numpy() for k in DET_KEYS}
        for i, md in enumerate(batch["metadata"]):
            token = md.get("token")
            if token in preds:
                continue  # padded repeat at the tail
            det = {k: out[k][i] for k in DET_KEYS}
            preds[token] = flip_back(det) if args.augment else det
        logger.info(f"scored {len(preds)}/{len(dataset)}")
    with open(args.out, "wb") as f:
        pickle.dump(preds, f)
    logger.info(f"predictions -> {args.out}")
    return preds


def main(argv=None):
    return predict_pool(parse_args(argv))


if __name__ == "__main__":
    main()
