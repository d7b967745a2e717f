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
kernel wrapper then takes its plain PyTorch version). Under ``torchrun
--nproc_per_node N`` it trains data parallel over N ranks (``nccl``, one
rank a card; ``gloo`` with ``--cpu``), as JAX's CLI trains over its
devices: the global batch is ``samples_per_gpu`` x N unless
``--batch_size`` names it (it must divide by N), ``lr_max`` is multiplied
by N, each rank trains on its rows of every global batch with the norms'
statistics, the gradients and the logs taken over the global batch
(``parallel``), and rank 0 writes the logs, checkpoints and
``estimator.npz``.

``--torch_init NPZ`` starts from the weights of a det3d checkpoint converted
by ``python -m dal3d_tpu_torch.tools.convert_second``; ``--resume_from`` and
``--load_from`` win over it, as in the JAX CLI.

A config with ``estimator`` (``configs/cbgs_partial.py``) trains the
detector and the box-quality ``Estimator`` side by side
(``runtime/active_trainer.py``): the estimator's weights start from ``seed +
1`` and are written after the run to ``<work_dir>/estimator.npz`` with the
JAX package's flat names and layouts (``Dense_<i>/kernel`` [in, out]). The
train set comes from ``data/dataset_factory.py`` by ``dataset_type``; the
partial-label dataset takes the config's top-level ``active_buffer``,
``active_flag``, ``sample_ratio``, ``label_fraction`` and ``partial_seed``
(with ``active_flag = "start"`` it writes the seed buffer ``partial_01``).

Not ported yet, refused with the ROADMAP item it waits for: ``--n_model >
1`` (A11.b, JAX's model axis).
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


def _refuse_unported(args) -> None:
    if args.n_model != 1:
        raise NotImplementedError("--n_model > 1: the mesh's model axis (the BEV maps split "
                                  "over cards) is not ported yet (ROADMAP A11.b)")


_PARTIAL_KNOBS = ("active_buffer", "active_flag", "sample_ratio", "label_fraction",
                  "partial_seed")


def _budget_path(path: str, budget: str) -> str:
    ext = os.path.splitext(path)[-1]
    return path.replace(ext, f"_{budget}{ext}")


def main(argv=None):
    args = parse_args(argv)
    from ..device import resolve_device
    from ..parallel.dist import init_dist, same_numpy_draws, write_once
    from ..parallel.mesh import global_batch_size

    _refuse_unported(args)
    rank, world = init_dist("gloo" if args.cpu else "nccl")
    device = resolve_device("cpu" if args.cpu else None)  # raises here without a GPU
    cfg = Config.fromfile(args.config)
    batch_size = global_batch_size(args.batch_size, cfg, world)

    from ..data import DataLoader
    from ..data.dataset_factory import build_dataset
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
    logger.info(f"device: {device}" + (f", rank {rank} of {world}" if world > 1 else ""))

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
    # the top-level dataset_type wins: configs set it after `from _base import
    # *`, when data.train.type already holds the base's value
    train_data.pop("type", None)
    dataset_type = cfg.get("dataset_type", "NuScenesDataset")
    if dataset_type in ("NUSC_PART", "NuScenesPartialDataset"):
        for k in _PARTIAL_KNOBS:  # the partial-label knobs live at the top level
            if cfg.get(k) is not None:
                train_data.setdefault(k, cfg[k])
    with same_numpy_draws():  # every rank resamples the same frames
        dataset = build_dataset(
            train_data,
            dataset_type=dataset_type,
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

    total_epochs = args.epochs or cfg.get("total_epochs", 20)
    steps_per_epoch = max(len(dataset) // batch_size, 1)
    if world > 1:
        logger.info(f"{world} ranks: global batch {batch_size}, lr_max x {world}")

    lr_cfg = cfg.get("lr_config", {}) or {}
    one_cycle = OneCycleSchedule(
        lr_max=lr_cfg.get("lr_max", 0.002) * world,
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
    trainer_kw = dict(
        one_cycle_cfg=one_cycle, logger=logger,
        log_interval=(cfg.get("log_config", {}) or {}).get("interval", 5),
        checkpoint_interval=(cfg.get("checkpoint_config", {}) or {}).get("interval", 1),
    )
    est_cfg = cfg.get("estimator")
    if est_cfg:
        # detector + box-quality estimator co-training
        import torch

        from ..models.detectors.estimator import Estimator, init_estimator_
        from ..runtime.active_trainer import ActiveTrainer
        from ..solver.optim import Adam

        est_kw = {k: v for k, v in dict(est_cfg).items() if k != "type"}
        estimator = init_estimator_(Estimator(**est_kw),
                                    torch.Generator().manual_seed((args.seed or 0) + 1))
        estimator.to(device)
        trainer = ActiveTrainer(bundle, optimizer, estimator,
                                Adam(float(cfg.get("estimator_lr", 1e-3))), work_dir,
                                **trainer_kw)
        logger.info("ActiveTrainer: detector + estimator co-training")
    else:
        trainer = Trainer(bundle, optimizer, work_dir, **trainer_kw)

    def loader_fn(epoch):
        return DataLoader(dataset, batch_size, shuffle=True, seed=epoch, rank=rank,
                          world=world)

    trainer.init_state()
    if est_cfg:
        trainer.init_estimator()
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
        from ..parallel.mesh import data_parallel_predict
        from ..runtime.evaluation import build_val_dataset, evaluate_dataset

        val_interval = next((int(n) for phase, n in workflow if phase == "train"), None)
        val_dataset = build_val_dataset(cfg)

        def val_fn(trainer):
            loader = DataLoader(val_dataset, batch_size, shuffle=False, drop_last=False,
                                rank=rank, world=world)
            result = evaluate_dataset(data_parallel_predict(trainer.predict_step), val_dataset,
                                      loader, work_dir, logger=logger, device=device)
            logger.info(f"val epoch {trainer.epoch}: {result}")
            return result

    trainer.run(loader_fn, total_epochs, val_fn=val_fn, val_interval=val_interval)
    if est_cfg:
        # the estimator's own checkpoint: JAX's flat names and layouts
        from ..models.convert_flax import estimator_to_flat

        est_path = os.path.join(work_dir, "estimator.npz")
        write_once(lambda: np.savez(est_path, **estimator_to_flat(trainer.estimator)))
        logger.info(f"saved estimator params -> {est_path}")
    logger.info("training done")
    return trainer


if __name__ == "__main__":
    main()
