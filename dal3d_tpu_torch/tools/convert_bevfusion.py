#!/usr/bin/env python
"""Convert a reference BEVFusion checkpoint (.pth; TransFusion-L or camera +
lidar) to the npz that ``--torch_init`` of the port's
``tools/train_bevfusion.py`` reads.

    python -m dal3d_tpu_torch.tools.convert_bevfusion ckpt.pth out.npz [--config CONFIG]

The npz holds the raw ``state_dict`` (mmcv's format: the dict itself, or
under ``state_dict`` / ``model``) in the JAX package's format, so either
package reads it. The mapping onto the flax names
(``models/bevfusion/convert_bevfusion.py::reference_to_flax``) runs here once
to validate the layout (the camera keys included); with
``--config`` the converted tensors are also loaded into the config's
BEVFusion, which checks every name and shape. It runs on the CUDA card;
``--cpu`` is the only way onto the CPU.
"""
import argparse

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="reference BEVFusion checkpoint -> npz for "
                                "--torch_init")
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

    from ..models.bevfusion.convert_bevfusion import (apply_torch_init_bevfusion,
                                                      reference_to_flax)
    from ..models.convert_second import save_raw_state_dict_npz

    ckpt = torch.load(args.torch_ckpt, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt.get("model", ckpt))
    sd = {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in sd.items()}
    flax = reference_to_flax(sd)  # raises on an unknown layout
    save_raw_state_dict_npz(sd, args.out_npz)
    msg = (f"wrote {args.out_npz}: {len(sd)} torch tensors -> {len(flax['params'])} params + "
           f"{len(flax['batch_stats'])} batch statistics")
    if args.config:
        from ..models.builder import build_bevfusion
        from ..utils.config import Config

        model = build_bevfusion(Config.fromfile(args.config), device=device).model
        apply_torch_init_bevfusion(model, args.out_npz)
        msg += f", loaded into {args.config}'s model"
    print(msg + " (validated)")
    return flax


if __name__ == "__main__":
    main()
