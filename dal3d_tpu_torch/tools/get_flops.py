#!/usr/bin/env python
"""Model complexity of the PyTorch port: parameter count and forward FLOPs
(port of JAX's ``tools/get_flops.py``; the reference's tools/get_flops.py:54).

    python -m dal3d_tpu_torch.tools.get_flops CONFIG [--batch_size 1] [--cpu]

JAX's inputs: ``--batch_size`` clouds of ``cfg.max_points`` zero points. A
BEVFusion config counts the lidar-only model, as JAX's does (the camera
branch needs images). It prints JAX's two lines, ``params: <M> M`` (the
model's parameters, never its buffers: JAX's ``variables["params"]``) and
``forward flops (...): <G> GFLOP``, then the split by stage into dense and
sparse work and the sparse convs' hits (``utils/flops.py``). The FLOPs are
those the inputs ask for, not XLA's cost of capped shapes, so the two
packages' figures differ (ROADMAP C.3). It runs on the CUDA card; ``--cpu``
is the only way onto the CPU.
"""
import argparse

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Parameter count and forward FLOPs")
    p.add_argument("config")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (plain kernel versions)")
    return p.parse_args(argv)


def is_bevfusion(cfg) -> bool:
    """JAX's test for a BEVFusion config."""
    return "BEVFusion" in str((cfg.get("model", {}) or {}).get("type", "")) or bool(
        (cfg.get("test_cfg", {}) or {}).get("out_size_factor"))


def flops_model(cfg, device):
    """The model JAX's get_flops counts: the CBGS detector of
    ``build_detector``, or BEVFusion lidar-only with the config's proposals,
    voxel caps and decoder channels (its other fields at their defaults);
    seeded weights, on ``device``."""
    from ..models.bevfusion import BEVFusion
    from ..models.bevfusion.sparse_encoder import VOXEL_CAPS
    from ..models.builder import build_detector, init_random_
    from ..ops.voxelize import VoxelConfig

    if not is_bevfusion(cfg):
        return build_detector(cfg, device=device).model
    vg, mc = cfg["voxel_generator"], dict(cfg["model"])
    vcfg = VoxelConfig(tuple(vg["range"]), tuple(vg["voxel_size"]),
                       int(vg["max_points_in_voxel"]), int(vg["max_voxel_num"]))
    model = BEVFusion(vcfg, with_camera=False,
                      num_proposals=int(mc.get("num_proposals", 200)),
                      voxel_caps=tuple(mc.get("voxel_caps", VOXEL_CAPS)),
                      decoder_channels=tuple(mc.get("decoder_channels", (128, 256))))
    init_random_(model, torch.Generator().manual_seed(0))
    return model.to(device).eval()


def main(argv=None) -> dict:
    """Prints the report; returns {"params", "flops", "dense", "sparse",
    "hits", "stages", "sparse_convs"}."""
    from ..device import resolve_device
    from ..utils.config import Config
    from ..utils.flops import count_forward_flops

    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    cfg = Config.fromfile(args.config)
    B, P = args.batch_size, int(cfg.get("max_points", 300000))
    model = flops_model(cfg, device)
    inputs = {"points": torch.zeros((B, P, 5), dtype=torch.float32, device=device),
              "points_valid": torch.ones((B, P), dtype=torch.bool, device=device)}
    count = count_forward_flops(model, inputs)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"params: {n_params / 1e6:.2f} M")
    print(f"forward flops (dense convs and linears by their shapes, sparse convs by their "
          f"hits, batch {B}): {count.total / 1e9:.2f} GFLOP")
    for stage, (dense, sparse) in count.stages.items():
        print(f"  {stage}: dense {dense / 1e9:.4f} GFLOP, sparse {sparse / 1e9:.4f} GFLOP")
    print(f"  sparse convs: {len(count.sparse_convs)}, {count.hits} hits "
          f"(input, output, tap), {count.sparse / 1e9:.4f} GFLOP; dense {count.dense / 1e9:.4f} "
          f"GFLOP ({device.type})")
    return dict(params=n_params, flops=count.total, dense=count.dense, sparse=count.sparse,
                hits=count.hits, stages=count.stages,
                sparse_convs=[tuple(r) for r in count.sparse_convs])


if __name__ == "__main__":
    main()
