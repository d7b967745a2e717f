"""TensorBoard scalars (port of ``dal3d_tpu/runtime/tb_logger.py``): torch's
``SummaryWriter`` when ``torch.utils.tensorboard`` imports, a no-op
otherwise.

The writer is opened at the first ``log`` call, and it writes through
tensorboard's TensorFlow-free stub: the ``tensorboard.compat.notf`` marker
(what tensorboard's TF-free build ships) makes ``tensorboard.compat.tf`` the
stub, so writing event files never imports TensorFlow where that is
installed, a slow import a training run has no use for."""
from __future__ import annotations

import sys
import types
from typing import Dict


class TensorboardLogger:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._w = None
        self._tried = False

    def _writer(self):
        if not self._tried:
            self._tried = True
            sys.modules.setdefault("tensorboard.compat.notf",
                                   types.ModuleType("tensorboard.compat.notf"))
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._w = SummaryWriter(self.log_dir)
            except Exception:  # tensorboard not installed
                self._w = None
        return self._w

    @property
    def active(self) -> bool:
        return self._writer() is not None

    def log(self, scalars: Dict[str, float], step: int):
        w = self._writer()
        if w is None:
            return
        for k, v in scalars.items():
            try:
                w.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass

    def close(self):
        if self._w is not None:
            self._w.close()
