#!/usr/bin/env python
"""Active-learning selection CLI of the PyTorch port.

    python -m dal3d_tpu_torch.tools.active_select CONFIG --checkpoint WORK_DIR

Flow and arguments of the JAX package's ``tools/active_select.py``:
- first round (buffer file missing): write ``{"0": []}`` and exit,
- otherwise: for a model-based selector without a cached scoring file, build
  the pool dataset (val pipeline over the TRAIN pool infos) and loader, the
  detector, load the checkpoint, and score the pool through the predict
  step; then build the selector, run the selection, and dump the updated
  buffer JSON + the selected infos subset pkl.

It runs on the CUDA card; ``--cpu`` is the only way onto the CPU (every
kernel wrapper then takes its plain PyTorch version).
"""
import argparse
import os
import random

import numpy as np

from ..utils.config import Config
from ..utils.fileio import dump
from ..utils.log import get_root_logger

MODEL_BASED = {
    "FeatureSelector", "EntropySelector", "BadgeSelector", "UWESelector",
    "PPALSelector", "SpatialFeatureSelector", "SpatialTemporalFeatureSelector",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Active-learning sample selection")
    p.add_argument("config", help="config file path")
    p.add_argument("--checkpoint", help="trained checkpoint work_dir (model-based selectors)")
    p.add_argument(
        "--force_random", action="store_true",
        help="override the configured selector with RandomSelector (seed round: "
        "the reference flow trains on a random seed buffer before the first "
        "model-based selection)",
    )
    p.add_argument("--seed", type=int, default=3407)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def init_sample_dataset(buffer_file: str):
    dump({"0": []}, buffer_file)


def build_pool_scoring(cfg, sel_cfg, device, checkpoint, batch_size=None, logger=None):
    """(score_fn, dataloader) of a model-based selector: the pool dataset in
    test mode over ``infos_origin``, and the predict step of the detector
    with the checkpoint's weights."""
    from ..data import DataLoader, NuScenesDataset
    from ..models.builder import build_detector, loader_voxelize_cfg
    from ..runtime import checkpoint as ckpt
    from ..runtime.steps import make_predict_step, predict_feed

    bundle = build_detector(cfg, device=device)
    # pool dataset: val pipeline, TRAIN pool infos
    val_data = dict(cfg["data"]["val"])
    dataset = NuScenesDataset(
        info_path=sel_cfg["infos_origin"],
        root_path=val_data.get("root_path", ""),
        nsweeps=val_data.get("nsweeps", 10),
        class_names=val_data.get("class_names"),
        pipeline=[dict(s) for s in val_data.get("pipeline", [])],
        tasks=[dict(t) for t in cfg["tasks"]],
        max_points=cfg.get("max_points", 300000),
        voxelize_host=loader_voxelize_cfg(cfg),
        test_mode=True,
    )
    batch_size = batch_size or cfg["data"].get("samples_per_gpu", 2)
    # one loader thread, as the JAX CLI: the sweep order of a frame is drawn
    # from numpy's global generator, so frames must be prepared in order for
    # a seed to give the same pool scores
    loader = DataLoader(dataset, batch_size, shuffle=False, drop_last=False)
    if not checkpoint:
        raise ValueError("model-based selector needs --checkpoint")
    _, meta = ckpt.load_checkpoint(checkpoint, bundle.model)
    if logger is not None:
        logger.info(f"loaded checkpoint epoch {meta.get('epoch')}")
    predict = make_predict_step(bundle)

    def score_fn(batch):
        return predict(predict_feed(batch))

    return score_fn, loader


def main(argv=None):
    args = parse_args(argv)
    device = "cpu" if args.cpu else None
    from ..device import resolve_device

    device = resolve_device(device)  # raises here, before any work, without a GPU
    random.seed(args.seed)
    np.random.seed(args.seed)

    cfg = Config.fromfile(args.config)
    logger = get_root_logger(None, cfg.get("log_level", "INFO"))
    sel_cfg = dict(cfg["selector"])

    buffer_file = sel_cfg["buffer_file"]
    if not os.path.exists(buffer_file):
        init_sample_dataset(buffer_file)
        logger.info(f"initialized empty AL buffer at {buffer_file}; run round 0 training first")
        return

    if args.force_random:
        sel_cfg = {
            "type": "RandomSelector",
            **{k: sel_cfg[k] for k in (
                "budget", "buffer_file", "dump_file_name", "infos_origin",
                "cost_b", "cost_f",
            ) if k in sel_cfg},
        }

    score_fn = dataloader = None
    if sel_cfg.get("type") in MODEL_BASED and not (
        sel_cfg.get("pred_store_file") and os.path.exists(sel_cfg["pred_store_file"])
    ):
        score_fn, dataloader = build_pool_scoring(cfg, sel_cfg, device, args.checkpoint,
                                                  args.batch_size, logger)

    from ..selectors import build_selector

    selector = build_selector(
        sel_cfg, default_args=dict(detector=score_fn, dataloader=dataloader, logger=logger,
                                   device=device)
    )
    selector.select_samples()
    selector.dump_file()
    logger.info("selection complete")


if __name__ == "__main__":
    main()
