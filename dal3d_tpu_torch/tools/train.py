#!/usr/bin/env python
"""Training CLI of the PyTorch port.

    python -m dal3d_tpu_torch.tools.train CONFIG --work_dir DIR [--epochs N] [--no_validate]

Flow and flags of the JAX package's ``tools/train.py``: load the
executable-python config, rewrite the info path with the AL budget suffix,
build the train dataset (CBGS resampling at load) and the detector, and run
the OneCycle AdamW workflow with per-epoch checkpoints
``<work_dir>/checkpoints/epoch_<n>.pth`` that ``--resume_from`` continues and
``python -m dal3d_tpu_torch.tools.active_select --checkpoint`` reads.

One difference in what a ``--seed`` gives: the JAX CLI draws a sample batch
to initialise its flax model, and the loader thread it leaves behind prepares
up to three more, all from numpy's global generator, before training starts.
A torch module needs no sample batch, so the port draws none, and the two
CLIs train on different augmentations of the same resampled frames (dataset,
pipeline and loader themselves give equal batches after equal draws).

It runs on the CUDA card; ``--cpu`` is the only way onto the CPU (every
kernel wrapper then takes its plain PyTorch version).

Not ported yet, each refused with the ROADMAP item it waits for: a workflow
with ``val`` phases unless ``--no_validate`` (A8), a ``db_sampler`` whose
database file exists (A8), ``estimator`` configs and the partial-label
dataset (A9), ``--torch_init`` (A1-5: the port-side det3d weights loader),
``--n_model > 1`` (A11).
"""
import argparse
import os

import numpy as np

from ..utils.config import Config
from ..utils.log import get_root_logger


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a detector")
    p.add_argument("config", help="config file path")
    p.add_argument("--work_dir", help="the dir to save logs and checkpoints")
    p.add_argument("--resume_from", help="checkpoint dir to resume from")
    p.add_argument("--load_from", help="checkpoint dir to warm-start weights from")
    p.add_argument("--torch_init", help="npz of a converted reference checkpoint (not ported)")
    p.add_argument("--budget", type=str, default=None, help="AL budget suffix for info paths")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None, help="override total epochs")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (plain kernel versions)")
    p.add_argument("--n_model", type=int, default=1, help="model-axis size (only 1 is ported)")
    p.add_argument("--no_validate", action="store_true",
                   help="skip the workflow's val phases")
    return p.parse_args(argv)


def _refuse_unported(args, cfg) -> None:
    if args.torch_init:
        raise NotImplementedError("--torch_init: the port-side loader of converted det3d "
                                  "checkpoints is not ported yet (ROADMAP A1-5)")
    if args.n_model != 1:
        raise NotImplementedError("--n_model > 1: the device mesh is not ported yet "
                                  "(ROADMAP A11)")
    if cfg.get("estimator"):
        raise NotImplementedError("estimator configs (ActiveTrainer, Estimator) are not "
                                  "ported yet (ROADMAP A9)")
    if cfg.get("dataset_type", "NuScenesDataset") not in ("NuScenesDataset", "NUSC"):
        raise NotImplementedError(f"dataset_type {cfg['dataset_type']!r} is not ported yet "
                                  "(ROADMAP A9)")
    workflow = cfg.get("workflow")
    if not args.no_validate and workflow and any(w[0] == "val" for w in workflow):
        raise NotImplementedError("the in-training val workflow is not ported yet (ROADMAP "
                                  "A8): pass --no_validate")


def main(argv=None):
    args = parse_args(argv)
    from ..device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)  # raises here without a GPU
    cfg = Config.fromfile(args.config)
    _refuse_unported(args, cfg)

    from ..data import DataLoader, NuScenesDataset
    from ..models.builder import build_detector, loader_voxelize_cfg
    from ..runtime.trainer import Trainer
    from ..solver.optim import OneCycleSchedule, build_optimizer

    if args.work_dir:
        cfg["work_dir"] = args.work_dir
    if args.seed is not None:
        np.random.seed(args.seed)
    work_dir = cfg["work_dir"]
    os.makedirs(work_dir, exist_ok=True)
    logger = get_root_logger(os.path.join(work_dir, "train.log"), cfg.get("log_level", "INFO"))
    logger.info(f"device: {device}")

    # AL budget path rewriting
    train_data = dict(cfg["data"]["train"])
    if args.budget is not None:
        ip = train_data["info_path"]
        ext = os.path.splitext(ip)[-1]
        train_data["info_path"] = ip.replace(ext, f"_{args.budget}{ext}")
        logger.info(f"AL budget {args.budget}: training on {train_data['info_path']}")
        db = cfg["train_preprocessor"].get("db_sampler") if cfg.get("train_preprocessor") else None
        if db:
            dbp = db["db_info_path"]
            dext = os.path.splitext(dbp)[-1]
            db["db_info_path"] = dbp.replace(dext, f"_{args.budget}{dext}")

    bundle = build_detector(cfg, device=device, seed=args.seed or 0)
    dataset = NuScenesDataset(
        info_path=train_data["info_path"],
        root_path=train_data.get("root_path", ""),
        nsweeps=train_data.get("nsweeps", 10),
        class_names=train_data.get("class_names"),
        pipeline=[dict(s) for s in train_data.get("pipeline", [])],
        tasks=[dict(t) for t in cfg["tasks"]],
        max_points=cfg.get("max_points", 300000),
        voxelize_host=loader_voxelize_cfg(cfg),
    )
    logger.info(f"dataset: {len(dataset)} frames after CBGS resampling")

    batch_size = args.batch_size or cfg["data"].get("samples_per_gpu", 2)
    total_epochs = args.epochs or cfg.get("total_epochs", 20)
    steps_per_epoch = max(len(dataset) // batch_size, 1)

    lr_cfg = cfg.get("lr_config", {}) or {}
    one_cycle = OneCycleSchedule(
        lr_max=lr_cfg.get("lr_max", 0.002),
        moms=tuple(lr_cfg.get("moms", (0.95, 0.85))),
        div_factor=lr_cfg.get("div_factor", 10.0),
        pct_start=lr_cfg.get("pct_start", 0.4),
        total_steps=steps_per_epoch * total_epochs,
    )
    optimizer = build_optimizer(
        one_cycle,
        weight_decay=(cfg.get("optimizer", {}) or {}).get("VALUE", {}).get("wd", 0.01),
        grad_clip_norm=(cfg.get("optimizer_config", {}) or {}).get("grad_clip", {}).get(
            "max_norm", 35.0),
    )
    trainer = Trainer(
        bundle, optimizer, work_dir, one_cycle_cfg=one_cycle, logger=logger,
        log_interval=(cfg.get("log_config", {}) or {}).get("interval", 5),
        checkpoint_interval=(cfg.get("checkpoint_config", {}) or {}).get("interval", 1),
    )

    def loader_fn(epoch):
        return DataLoader(dataset, batch_size, shuffle=True, seed=epoch)

    trainer.init_state()
    if args.resume_from:
        # the value may be a checkpoint dir; anything else resumes from work_dir
        rd = args.resume_from if os.path.isdir(str(args.resume_from)) else None
        trainer.resume(work_dir=rd)
    elif args.load_from:
        trainer.load_from(args.load_from)

    trainer.run(loader_fn, total_epochs)
    logger.info("training done")
    return trainer


if __name__ == "__main__":
    main()
