#!/usr/bin/env python
"""Convert a det3d CBGS VoxelNet checkpoint (.pth) to the npz that the port's
``--torch_init`` reads (``tools/train.py``, ``tools/test.py``,
``tools/dist_test.py``).

    python -m dal3d_tpu_torch.tools.convert_second ckpt.pth out.npz [--config CONFIG]

The npz holds the raw ``state_dict`` (torchie's ``save_checkpoint`` format:
the dict itself, or under ``state_dict`` / ``model``), in the JAX package's
format, so either package reads it. The mapping onto the port's names
(``models/convert_second.py``) runs here once, to validate the layout; with
``--config`` the converted tensors are also loaded into the config's
FPNVoxelNet, which checks every name and shape. It runs on the CUDA card;
``--cpu`` is the only way onto the CPU.
"""
import argparse

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="det3d checkpoint -> npz for --torch_init")
    p.add_argument("torch_ckpt")
    p.add_argument("out_npz")
    p.add_argument("--config", help="also load the result into this config's model")
    p.add_argument("--cpu", action="store_true", help="build the model on the CPU")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)  # raises here without a GPU
    import torch

    from ..models.convert_second import (apply_torch_init, convert_second_state_dict,
                                         save_raw_state_dict_npz)

    ckpt = torch.load(args.torch_ckpt, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt.get("model", ckpt))
    sd = {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in sd.items()}
    mapped = convert_second_state_dict(sd)  # raises on an unknown layout
    save_raw_state_dict_npz(sd, args.out_npz)
    msg = f"wrote {args.out_npz}: {len(sd)} torch tensors -> {len(mapped)} port tensors"
    if args.config:
        from ..models.builder import build_detector
        from ..utils.config import Config

        model = build_detector(Config.fromfile(args.config), device=device).model
        apply_torch_init(model, args.out_npz)
        msg += f", loaded into {args.config}'s model"
    print(msg + " (validated)")
    return mapped


if __name__ == "__main__":
    main()
