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


def _resolve(work_dir: str, epoch: Optional[int]) -> str:
    """The checkpoint file: ``work_dir`` itself when it is a file, else the
    given or latest epoch under it."""
    if os.path.isfile(work_dir):
        return work_dir
    if epoch is None:
        epoch = latest_epoch(work_dir)
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints under {work_dir}")
    return _path(work_dir, epoch)


def load_checkpoint(work_dir: str, model: torch.nn.Module, epoch: Optional[int] = None,
                    optimizer=None) -> Tuple[torch.nn.Module, dict]:
    """Load what ``save_checkpoint`` saved into ``model`` (on its own device)
    and, when given, into ``optimizer`` (the file must then hold its state).
    ``work_dir`` may also name the ``.pth`` file itself. Returns (model,
    meta)."""
    path = _resolve(work_dir, epoch)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ckpt["state_dict"])
    if optimizer is not None:
        if "optimizer" not in ckpt:
            raise KeyError(f"{path} holds no optimizer state")
        optimizer.load_state_dict(ckpt["optimizer"])
    return model, dict(ckpt.get("meta", {}))


def load_partial_params(work_dir: str, model: torch.nn.Module, epoch: Optional[int] = None,
                        optimizer=None, logger=None) -> Tuple[int, int]:
    """Warm start across model structures (JAX's ``load_partial_params``,
    the BEVFusion stage-1 -> stage-2 transfer): every parameter and buffer of
    ``model`` whose name and shape match an entry of the checkpoint takes its
    value; the others keep theirs. The optimizer, when given, starts afresh
    (zero moments, count 0), as JAX's new optimizer state. ``work_dir`` may
    name the ``.pth`` file. Returns (copied, kept)."""
    path = _resolve(work_dir, epoch)
    src = torch.load(path, map_location="cpu", weights_only=True)["state_dict"]
    copied = kept = 0
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k in src and tuple(src[k].shape) == tuple(v.shape):
                v.copy_(src[k])
                copied += 1
            else:
                kept += 1
    if optimizer is not None:
        optimizer.init(model.named_parameters())
    if logger is not None:
        logger.info(f"partial warm-start from {path}: {copied} tensors copied, {kept} kept "
                    "their init")
    return copied, kept
