#!/usr/bin/env python
"""Training CLI of the PyTorch port.

    python -m dal3d_tpu_torch.tools.train CONFIG --work_dir DIR [--epochs N] [--no_validate]

Flow and flags of the JAX package's ``tools/train.py``: load the
executable-python config, rewrite the info and GT-database paths with the AL
budget suffix, build the train dataset (CBGS resampling at load) and the
detector, and run the OneCycle AdamW workflow with per-epoch checkpoints
``<work_dir>/checkpoints/epoch_<n>.pth`` that ``--resume_from`` continues and
``python -m dal3d_tpu_torch.tools.active_select --checkpoint`` reads. A
workflow with a ``val`` phase evaluates the config's ``data.val`` set every
``train`` epochs of the workflow and after the last (``--no_validate`` skips
it); the result is logged as ``val epoch <n>: {...}``.

One difference in what ``--budget`` does: the JAX CLI rewrites the GT-AUG
database path in ``train_preprocessor``, a copy of the config that the train
pipeline never reads, so its budgeted runs paste from the full database; the
port rewrites the path in the train pipeline's ``Preprocess`` stage, so a
budgeted run pastes only the objects of the selected subset (the database
that ``create_data nuscenes_data_prep --suffix`` writes).

One difference in what a ``--seed`` gives: the JAX CLI draws a sample batch
to initialise its flax model, and the loader thread it leaves behind prepares
up to three more, all from numpy's global generator, before training starts.
A torch module needs no sample batch, so the port draws none, and the two
CLIs train on different augmentations of the same resampled frames (dataset,
pipeline and loader themselves give equal batches after equal draws).

It runs on the CUDA card; ``--cpu`` is the only way onto the CPU (every
kernel wrapper then takes its plain PyTorch version).

``--torch_init NPZ`` starts from the weights of a det3d checkpoint converted
by ``python -m dal3d_tpu_torch.tools.convert_second``; ``--resume_from`` and
``--load_from`` win over it, as in the JAX CLI.

Not ported yet, each refused with the ROADMAP item it waits for:
``estimator`` configs and the partial-label dataset (A9), ``--n_model > 1``
(A11).
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
    p.add_argument("--torch_init", help="npz of a converted det3d checkpoint "
                   "(tools/convert_second.py)")
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
    if args.n_model != 1:
        raise NotImplementedError("--n_model > 1: the device mesh is not ported yet "
                                  "(ROADMAP A11)")
    if cfg.get("estimator"):
        raise NotImplementedError("estimator configs (ActiveTrainer, Estimator) are not "
                                  "ported yet (ROADMAP A9)")
    if cfg.get("dataset_type", "NuScenesDataset") not in ("NuScenesDataset", "NUSC"):
        raise NotImplementedError(f"dataset_type {cfg['dataset_type']!r} is not ported yet "
                                  "(ROADMAP A9)")


def _budget_path(path: str, budget: str) -> str:
    ext = os.path.splitext(path)[-1]
    return path.replace(ext, f"_{budget}{ext}")


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

    # AL budget path rewriting: the infos, and the GT-AUG database of the
    # Preprocess stages the train pipeline builds
    train_data = dict(cfg["data"]["train"])
    if args.budget is not None:
        train_data["info_path"] = _budget_path(train_data["info_path"], args.budget)
        logger.info(f"AL budget {args.budget}: training on {train_data['info_path']}")
        for stage in train_data.get("pipeline", []):
            db = stage.get("cfg", {}).get("db_sampler") if stage["type"] == "Preprocess" else None
            if db:
                db["db_info_path"] = _budget_path(db["db_info_path"], args.budget)
                logger.info(f"AL budget {args.budget}: GT-AUG database {db['db_info_path']}")

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
    elif args.torch_init:
        from ..models.convert_second import apply_torch_init

        apply_torch_init(bundle.model, args.torch_init, logger=logger)
        logger.info(f"warm-started from converted torch checkpoint {args.torch_init}")

    # in-training val workflow [('train', N), ('val', 1)]: evaluate every N
    # train epochs and after the last
    val_fn = val_interval = None
    workflow = cfg.get("workflow")
    if not args.no_validate and workflow and any(w[0] == "val" for w in workflow):
        from ..runtime.evaluation import build_val_dataset, evaluate_dataset

        val_interval = next((int(n) for phase, n in workflow if phase == "train"), None)
        val_dataset = build_val_dataset(cfg)

        def val_fn(trainer):
            loader = DataLoader(val_dataset, batch_size, shuffle=False, drop_last=False)
            result = evaluate_dataset(trainer.predict_step, val_dataset, loader, work_dir,
                                      logger=logger, device=device)
            logger.info(f"val epoch {trainer.epoch}: {result}")
            return result

    trainer.run(loader_fn, total_epochs, val_fn=val_fn, val_interval=val_interval)
    logger.info("training done")
    return trainer


if __name__ == "__main__":
    main()
