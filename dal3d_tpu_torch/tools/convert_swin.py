#!/usr/bin/env python
"""Convert a torch Swin checkpoint (microsoft / timm or mmdet naming, e.g.
the reference's pretrained swint-nuimages) to the npz that ``--swin_init``
of the port's ``tools/train_bevfusion.py`` reads.

    python -m dal3d_tpu_torch.tools.convert_swin swint.pth swint.npz
        [--depths 2,2,6,2] [--out_indices 1,2,3]

The npz holds the flat flax names of the JAX package's SwinTransformer
(``Conv_0/kernel``, ``SwinBlock_<n>/...``), the JAX tool's format, so either
package's ``--swin_init`` reads it. Host only: no device is used.
"""
import argparse

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="torch Swin checkpoint -> npz for --swin_init")
    p.add_argument("torch_ckpt")
    p.add_argument("out_npz")
    p.add_argument("--depths", default="2,2,6,2")
    p.add_argument("--out_indices", default="1,2,3")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from ..models.bevfusion.convert_swin import convert_swin_state_dict

    ckpt = torch.load(args.torch_ckpt, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt.get("model", ckpt))
    sd = {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in sd.items()}
    flat = convert_swin_state_dict(
        sd, depths=tuple(int(x) for x in args.depths.split(",")),
        out_indices=tuple(int(x) for x in args.out_indices.split(",")))
    np.savez(args.out_npz, **flat)
    print(f"wrote {len(flat)} arrays to {args.out_npz}")
    return flat


if __name__ == "__main__":
    main()
