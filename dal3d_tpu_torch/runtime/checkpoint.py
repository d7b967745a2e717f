"""Checkpoint save / load of the port's weights (the part of
``dal3d_tpu/runtime/checkpoint.py`` that the selection CLI needs; optimizer
state and resume come with the training slice).

A checkpoint is one torch file ``<work_dir>/checkpoints/epoch_<n>.pth``
holding ``{"meta": {"epoch", ...}, "state_dict": model.state_dict()}``.
"""
from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import torch


def _path(work_dir: str, epoch: int) -> str:
    return os.path.join(work_dir, "checkpoints", f"epoch_{epoch}.pth")


def save_checkpoint(work_dir: str, model: torch.nn.Module, epoch: int,
                    meta: Optional[dict] = None) -> str:
    os.makedirs(os.path.join(work_dir, "checkpoints"), exist_ok=True)
    m = {"epoch": epoch}
    if meta:
        m.update(meta)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    path = _path(work_dir, epoch)
    torch.save({"meta": m, "state_dict": state}, path)
    return path


def latest_epoch(work_dir: str) -> Optional[int]:
    d = os.path.join(work_dir, "checkpoints")
    if not os.path.isdir(d):
        return None
    epochs = [int(m.group(1)) for m in (re.fullmatch(r"epoch_(\d+)\.pth", f)
                                        for f in os.listdir(d)) if m]
    return max(epochs) if epochs else None


def load_checkpoint(work_dir: str, model: torch.nn.Module,
                    epoch: Optional[int] = None) -> Tuple[torch.nn.Module, dict]:
    """Load the weights saved by ``save_checkpoint`` into ``model`` (on its
    own device). ``work_dir`` may also name the ``.pth`` file itself.
    Returns (model, meta)."""
    if os.path.isfile(work_dir):
        path = work_dir
    else:
        if epoch is None:
            epoch = latest_epoch(work_dir)
            if epoch is None:
                raise FileNotFoundError(f"no checkpoints under {work_dir}")
        path = _path(work_dir, epoch)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["state_dict"])
    return model, dict(ckpt.get("meta", {}))
