#!/usr/bin/env python
"""BEVFusion training CLI of the PyTorch port: lidar-only stage 1, and
camera + lidar stage 2 (``configs/bevfusion_cl.py``, ``--load_from`` the
stage-1 work dir).

    python -m dal3d_tpu_torch.tools.train_bevfusion CONFIG [--work_dir DIR] [--budget B]
        [--epochs N] [--batch_size B] [--load_from DIR] [--resume_from DIR]
        [--torch_init NPZ] [--swin_init NPZ] [--cpu]

Flow and flags of the JAX package's ``tools/train_bevfusion.py``: build the
BEVFusion of the config (``models/builder.py::build_bevfusion``),
the train set (``--budget B`` reads the ``_B`` infos that ``create_data
nuscenes_data_prep --suffix`` writes), the OneCycle AdamW over
``max(len // batch, 1) * epochs`` steps, then per batch: the per-task GT
folded into global classes (task t's classes offset by the classes of the
tasks before it), one train step (``runtime/bevfusion_steps.py``), a log line
every ``log_config.interval`` steps, and a checkpoint
``<work_dir>/checkpoints/epoch_<n>.pth`` after every epoch.

Warm starts: ``--resume_from`` (a checkpoint dir, else the work dir) loads
weights and optimizer and continues the step count and the epochs;
``--load_from`` copies every tensor whose name and shape match into the new
model and starts a fresh optimizer (stage 2's warm start from stage 1; it
exits when nothing matches); ``--torch_init`` loads a reference checkpoint
converted by ``python -m dal3d_tpu_torch.tools.convert_bevfusion``. Resume
wins over the other two, and ``--load_from`` over ``--torch_init``, as in the
JAX CLI. ``--swin_init`` then loads a pretrained Swin converted by ``python
-m dal3d_tpu_torch.tools.convert_swin`` into the camera backbone (a config
without the camera branch raises).

One difference: the JAX CLI's epoch loop starts at epoch 0 after a resume
(it reruns every epoch with the resumed step count); the port continues at
the epoch after the checkpoint's, as the CBGS trainer and the reference's
runner do.

It runs on the CUDA card; ``--cpu`` is the only way onto the CPU (every
kernel wrapper then takes its plain PyTorch version). A config with
``with_map_seg`` (``configs/bevfusion_cl_synthetic.py``) trains the map
segmentation head beside the detector on its pipeline's
``LoadBEVSegmentation`` targets (``gt_masks_bev``, kept in the batch), and
logs ``seg``. Not ported yet, refused with the ROADMAP item it waits for:
``--n_model > 1`` (A11.b, JAX's model axis). A ``head="centerpoint"``
config is refused by the train step: JAX's CLI has no CenterPoint path
(ROADMAP C.4).

Under ``torchrun --nproc_per_node N`` it trains data parallel over N ranks
(``nccl``, one rank a card; ``gloo`` with ``--cpu``): the global batch is
``samples_per_gpu`` x N unless ``--batch_size`` names it (it must divide by
N; JAX's CLI multiplies a given ``--batch_size`` by its devices too), the
learning rate is the config's (as in JAX), each rank trains on its rows of
every global batch (``parallel``), and rank 0 writes the log and the
checkpoints.
"""
import argparse
import os

import numpy as np

from ..runtime.bevfusion_steps import CAMERA_KEYS
from ..utils.config import Config
from ..utils.log import get_root_logger

BATCH_KEYS = ("points", "points_valid", "voxel_features", "voxel_coords",
              "voxel_valid", "gt_masks_bev") + CAMERA_KEYS


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train BEVFusion (lidar-only or camera + lidar)")
    p.add_argument("config")
    p.add_argument("--work_dir", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--load_from", default=None,
                   help="checkpoint dir: copy the tensors whose name and shape match")
    p.add_argument("--resume_from", default=None)
    p.add_argument("--swin_init", default=None,
                   help="npz of tools/convert_swin.py: a pretrained camera backbone")
    p.add_argument("--torch_init", default=None,
                   help="npz of tools/convert_bevfusion.py: a converted reference checkpoint")
    p.add_argument("--budget", type=str, default=None,
                   help="AL budget suffix: train on infos_*_{budget}.pkl")
    p.add_argument("--n_model", type=int, default=1, help="model-axis size (only 1 is ported)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (plain kernel versions)")
    return p.parse_args(argv)


def fusion_batch(batch, tasks) -> dict:
    """A loader batch -> the train step's: the lidar and camera inputs, the
    map targets when the pipeline makes them, and the per-task
    GT lists folded into [B, sum G_t, 9] boxes and [B, sum G_t] global
    1-based classes (task t's class c becomes c + the classes of the tasks
    before it; 0 stays padding)."""
    out = {k: v for k, v in batch.items() if k in BATCH_KEYS}
    offset, classes = 0, []
    for t, c in enumerate(batch["gt_classes"]):
        classes.append(np.where(c > 0, c + offset, 0).astype(np.int32))
        offset += int(tasks[t]["num_class"])
    out["gt_boxes"] = np.concatenate(batch["gt_boxes"], axis=1)
    out["gt_classes"] = np.concatenate(classes, axis=1)
    return out


def main(argv=None):
    args = parse_args(argv)
    from ..device import resolve_device
    from ..parallel.dist import init_dist, same_numpy_draws, synchronize
    from ..parallel.mesh import global_batch_size
    from .train import _refuse_unported

    _refuse_unported(args)
    rank, world = init_dist("gloo" if args.cpu else "nccl")
    device = resolve_device("cpu" if args.cpu else None)  # raises here without a GPU
    cfg = Config.fromfile(args.config)
    batch_size = global_batch_size(args.batch_size, cfg, world)

    from ..data import DataLoader
    from ..data.dataset_factory import build_dataset
    from ..models.builder import bevfusion_optimizer, build_bevfusion, loader_voxelize_cfg
    from ..runtime import checkpoint as ckpt
    from ..runtime.bevfusion_steps import make_bevfusion_train_step

    work_dir = args.work_dir or cfg["work_dir"]
    os.makedirs(work_dir, exist_ok=True)
    logger = get_root_logger(os.path.join(work_dir, "train.log"))
    logger.info(f"device: {device}")

    bundle = build_bevfusion(cfg, device=device)
    train_data = dict(cfg["data"]["train"])
    if args.budget is not None:
        ip = train_data["info_path"]
        ext = os.path.splitext(ip)[-1]
        train_data["info_path"] = ip.replace(ext, f"_{args.budget}{ext}")
        logger.info(f"AL budget {args.budget}: training on {train_data['info_path']}")
    train_data.pop("type", None)
    tasks = [dict(t) for t in cfg["tasks"]]
    with same_numpy_draws():  # every rank resamples the same frames
        dataset = build_dataset(
            train_data, dataset_type=cfg.get("dataset_type", "NuScenesDataset"),
            info_path=train_data["info_path"], root_path=train_data.get("root_path", ""),
            nsweeps=train_data.get("nsweeps", 10), class_names=train_data.get("class_names"),
            pipeline=[dict(s) for s in train_data.get("pipeline", [])], tasks=tasks,
            max_points=cfg.get("max_points", 300000), voxelize_host=loader_voxelize_cfg(cfg))
    total_epochs = args.epochs or cfg.get("total_epochs", 20)
    steps = max(len(dataset) // batch_size, 1) * total_epochs
    optimizer = bevfusion_optimizer(cfg, bundle, steps)
    step = make_bevfusion_train_step(bundle, optimizer)

    start = 0
    if args.resume_from:
        rd = args.resume_from if os.path.isdir(str(args.resume_from)) else work_dir
        _, meta = ckpt.load_checkpoint(rd, bundle.model, optimizer=optimizer)
        start = int(meta.get("epoch", 0))
        logger.info(f"resumed epoch {start} (step {optimizer.count}) from {rd}")
    elif args.load_from:
        copied, _ = ckpt.load_partial_params(args.load_from, bundle.model, optimizer=optimizer,
                                             logger=logger)
        if copied == 0:
            raise SystemExit(f"--load_from {args.load_from}: no matching tensors")
        logger.info(f"warm-started from {args.load_from}")
    elif args.torch_init:
        from ..models.bevfusion.convert_bevfusion import apply_torch_init_bevfusion

        apply_torch_init_bevfusion(bundle.model, args.torch_init, logger)
        logger.info(f"warm-started from converted torch checkpoint {args.torch_init}")
    if args.swin_init:
        from ..models.bevfusion.convert_swin import load_swin_npz

        if not bundle.model.with_camera:
            raise SystemExit(f"--swin_init {args.swin_init}: the model has no camera branch")
        n = load_swin_npz(bundle.model.camera_backbone, args.swin_init)
        logger.info(f"camera backbone initialised from {args.swin_init} ({n} tensors)")

    interval = (cfg.get("log_config", {}) or {}).get("interval", 5)
    logs = {}
    for epoch in range(start, total_epochs):
        for i, batch in enumerate(DataLoader(dataset, batch_size, shuffle=True, seed=epoch,
                                             rank=rank, world=world)):
            logs = step(fusion_batch(batch, tasks))
            if rank == 0 and (i + 1) % interval == 0:
                lg = {k: float(v) for k, v in logs.items()}
                logger.info(
                    f"Epoch [{epoch + 1}][{i + 1}] loss {lg['loss']:.4f} (cls "
                    f"{lg['cls_loss']:.3f} reg {lg['reg_loss']:.3f} hm {lg['heatmap_loss']:.3f} "
                    f"seg {lg['seg_loss']:.3f}) matched {int(lg['num_matched'])} grad_norm "
                    f"{lg['grad_norm']:.2f}")
        if rank == 0:
            ckpt.save_checkpoint(work_dir, bundle.model, epoch + 1,
                                 meta={"global_step": optimizer.count}, optimizer=optimizer)
        synchronize()
        logger.info(f"saved epoch {epoch + 1}")
    logger.info("training done")
    return {"bundle": bundle, "optimizer": optimizer,
            "logs": {k: float(v) for k, v in logs.items()}}


if __name__ == "__main__":
    main()
