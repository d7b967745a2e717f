"""Checkpoint save / load / resume (port of
``dal3d_tpu/runtime/checkpoint.py``, a torch file in place of orbax).

A checkpoint is one file ``<work_dir>/checkpoints/epoch_<n>.pth`` holding
``{"meta": {"epoch", "global_step", ...}, "state_dict": model.state_dict(),
"optimizer": optimizer.state_dict()}``; the optimizer entry is there when the
trainer saved it and is read only when an optimizer is handed to
``load_checkpoint`` (the selection CLI loads the weights alone).
"""
from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import torch


def _path(work_dir: str, epoch: int) -> str:
    return os.path.join(work_dir, "checkpoints", f"epoch_{epoch}.pth")


def save_checkpoint(work_dir: str, model: torch.nn.Module, epoch: int,
                    meta: Optional[dict] = None, optimizer=None) -> str:
    os.makedirs(os.path.join(work_dir, "checkpoints"), exist_ok=True)
    m = {"epoch": epoch}
    if meta:
        m.update(meta)
    ckpt = {"meta": m,
            "state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()}}
    if optimizer is not None:
        ckpt["optimizer"] = optimizer.state_dict()
    path = _path(work_dir, epoch)
    torch.save(ckpt, path)
    return path


def latest_epoch(work_dir: str) -> Optional[int]:
    d = os.path.join(work_dir, "checkpoints")
    if not os.path.isdir(d):
        return None
    epochs = [int(m.group(1)) for m in (re.fullmatch(r"epoch_(\d+)\.pth", f)
                                        for f in os.listdir(d)) if m]
    return max(epochs) if epochs else None


def load_checkpoint(work_dir: str, model: torch.nn.Module, epoch: Optional[int] = None,
                    optimizer=None) -> Tuple[torch.nn.Module, dict]:
    """Load what ``save_checkpoint`` saved into ``model`` (on its own device)
    and, when given, into ``optimizer`` (the file must then hold its state).
    ``work_dir`` may also name the ``.pth`` file itself. Returns (model,
    meta)."""
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
    if optimizer is not None:
        if "optimizer" not in ckpt:
            raise KeyError(f"{path} holds no optimizer state")
        optimizer.load_state_dict(ckpt["optimizer"])
    return model, dict(ckpt.get("meta", {}))
