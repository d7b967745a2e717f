"""Epoch-based trainer (port of ``dal3d_tpu/runtime/trainer.py``).

The train step does the work; the trainer owns the epoch / iteration loop,
LogBuffer-style averaged text logging every ``log_interval`` steps (also to
tensorboard where it is installed, ``runtime/tb_logger.py``), the brick
capacity report on the first batch (``runtime/capacity.py``), per-epoch
checkpointing, iteration timing, resume, and the val phases of the workflow
(a ``val_fn`` every ``val_interval`` epochs and after the last).
``after_train_step`` is the hook a subclass runs after each train step
(``runtime/active_trainer.py``: the estimator step).

In a world of several ranks (``parallel``) every rank runs the loop on its
rows of each global batch; rank 0 alone writes the log lines, tensorboard,
the capacity report and the checkpoints, and every rank waits at a barrier
after a checkpoint. ``resume`` and ``load_from`` load on every rank.
"""
from __future__ import annotations

import logging
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np

from ..parallel.dist import get_dist_info, synchronize
from ..solver.optim import one_cycle_lr
from . import checkpoint as ckpt
from .steps import make_predict_step, make_train_step


class LogBuffer:
    def __init__(self):
        self.history = defaultdict(list)

    def update(self, d: Dict[str, float]):
        for k, v in d.items():
            self.history[k].append(float(v))

    def average(self, n: int = 0) -> Dict[str, float]:
        return {k: float(np.mean(v[-n:] if n else v)) for k, v in self.history.items()}

    def clear(self):
        self.history.clear()


class Trainer:
    """Holds the model (through its bundle), the optimizer, the global step
    and the epoch. ``step`` is what the log's learning rate is read at;
    the optimizer keeps its own count for the schedules, as optax does."""

    def __init__(self, bundle, optimizer, work_dir: str, one_cycle_cfg=None,
                 logger: Optional[logging.Logger] = None, log_interval: int = 5,
                 checkpoint_interval: int = 1):
        self.bundle = bundle
        self.optimizer = optimizer
        self.work_dir = work_dir
        self.logger = logger or logging.getLogger("dal3d.trainer")
        self.log_interval = log_interval
        self.checkpoint_interval = checkpoint_interval
        self.train_step = make_train_step(bundle, optimizer)
        self.predict_step = make_predict_step(bundle)
        self.lr_fn = one_cycle_lr(one_cycle_cfg) if one_cycle_cfg is not None else None
        self.initialized = False
        self.step = 0
        self.epoch = 0
        self._capacity_checked = False
        from .tb_logger import TensorboardLogger

        self.tb = TensorboardLogger(work_dir)

    # ------------------------------------------------------------------
    def init_state(self):
        """Bind the optimizer to the model's parameters (fresh moments, count
        0); the model keeps the weights it was built or loaded with."""
        model = self.bundle.model
        self.optimizer.init(model.named_parameters())
        self.step = 0
        self.initialized = True
        n_params = sum(p.numel() for p in model.parameters())
        self.logger.info(f"initialized model: {n_params/1e6:.2f}M params")

    def save(self):
        """The epoch's checkpoint, written by rank 0; every rank then waits
        for it. Returns its path (None on the other ranks)."""
        path = None
        if get_dist_info()[0] == 0:
            path = ckpt.save_checkpoint(self.work_dir, self.bundle.model, self.epoch,
                                        meta={"global_step": self.step},
                                        optimizer=self.optimizer)
        synchronize()
        return path

    def resume(self, epoch: Optional[int] = None, work_dir: Optional[str] = None):
        """Resume from ``work_dir`` (defaults to the trainer's own)."""
        _, meta = ckpt.load_checkpoint(work_dir or self.work_dir, self.bundle.model, epoch,
                                       optimizer=self.optimizer)
        self.epoch = int(meta.get("epoch", 0))
        self.step = int(meta.get("global_step", 0))
        self.logger.info(f"resumed from epoch {self.epoch} (step {self.step})")

    def load_from(self, path_or_workdir: str, epoch: Optional[int] = None):
        """Warm start: the whole saved state, with the step reset to 0."""
        ckpt.load_checkpoint(path_or_workdir, self.bundle.model, epoch, optimizer=self.optimizer)
        self.step = 0

    # ------------------------------------------------------------------
    def train_epoch(self, loader: Iterable[Dict[str, Any]]):
        buf = LogBuffer()
        primary = get_dist_info()[0] == 0
        t_data = time.perf_counter()
        for i, batch in enumerate(loader):
            data_time = time.perf_counter() - t_data
            batch = {k: v for k, v in batch.items() if k != "metadata"}
            if primary and not self._capacity_checked:
                # one-shot: a saturated brick level drops voxels silently
                self._capacity_checked = True
                from .capacity import log_capacity_report

                log_capacity_report(self, batch)
            logs = self.train_step(batch)
            self.step += 1
            logs = {k: float(v) for k, v in logs.items()}  # waits for the device
            logs = self.after_train_step(batch, logs)
            iter_time = time.perf_counter() - t_data
            buf.update({**logs, "data_time": data_time, "time": iter_time})
            if primary and (i + 1) % self.log_interval == 0:
                avg = buf.average(self.log_interval)
                self.tb.log(avg, self.step)
                lr = float(self.lr_fn(self.step)) if self.lr_fn else float("nan")
                self.logger.info(
                    f"Epoch [{self.epoch + 1}][{i + 1}] lr: {lr:.5f}, "
                    f"time: {avg['time']:.3f} ({avg['data_time']:.3f} data), "
                    f"loss: {avg['loss']:.4f} (loc {avg['loc_loss']:.4f} / cls {avg['cls_loss']:.4f}), "
                    f"grad_norm: {avg['grad_norm']:.2f}, num_pos: {avg['num_pos']:.0f}"
                )
            t_data = time.perf_counter()
        self.epoch += 1
        return buf.average()

    def after_train_step(self, batch: Dict[str, Any], logs: Dict[str, float]) -> Dict[str, float]:
        """Runs after each train step with its batch and float logs; returns
        the logs to record."""
        return logs

    def run(self, train_loader_fn: Callable[[int], Iterable], total_epochs: int,
            val_fn: Optional[Callable[["Trainer"], Dict]] = None,
            val_interval: Optional[int] = None):
        """Workflow [('train', val_interval), ('val', 1)] cycled up to
        ``total_epochs``: a checkpoint every ``checkpoint_interval`` epochs
        and after the last; ``val_fn(self)`` every ``val_interval`` epochs and
        after the last (``val_interval`` None: after the last only). Returns
        the last val result, or None."""
        if not self.initialized:
            raise RuntimeError("call init_state first")
        result = None
        while self.epoch < total_epochs:
            stats = self.train_epoch(train_loader_fn(self.epoch))
            self.logger.info(f"Epoch {self.epoch} done: loss {stats.get('loss', float('nan')):.4f}")
            if self.epoch % self.checkpoint_interval == 0 or self.epoch == total_epochs:
                self.save()
                self.logger.info(f"saved checkpoint epoch {self.epoch}")
            at_val = val_interval is not None and self.epoch % val_interval == 0
            if val_fn is not None and (at_val or self.epoch == total_epochs):
                result = val_fn(self)
        return result
