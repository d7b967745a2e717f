#!/usr/bin/env python
"""Predict FPS harness of the PyTorch port (port of JAX's
``tools/benchmark.py``; the reference's bevfusion/tools/benchmark.py:58-84).

    python -m dal3d_tpu_torch.tools.benchmark CONFIG [--batch_size 2] [--iters 20]
        [--warmup 3] [--points 250000] [--cpu]

JAX's scope and clouds: a CBGS config through ``models/builder.py::
build_detector`` with its seeded weights, and ``--batch_size``
clouds of ``--points`` points from ``np.random.RandomState(0)`` (x, y
uniform in +-50 m, z in [-4.9, 2.9], the other features 0), fed raw to
``runtime/steps.py::make_predict_step`` (the device voxelizer, the
backbone, the neck, the head, decode and NMS). After ``--warmup`` predicts
it times ``--iters``, each ending with a fetch of the scores' sum, as JAX's
loop does, and prints JAX's line ``batch B: <ms> ms/iter -> <n> scans/s``.
On the card a second line gives the median device time of a timed predict
between CUDA events recorded around it (host gaps inside the predict
included) and the card's name and power limit. It writes no file. It runs
on the CUDA card; ``--cpu`` is the only way onto the CPU.
"""
import argparse
import subprocess
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Predict FPS of a CBGS config")
    p.add_argument("config")
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--points", type=int, default=250000)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (plain kernel versions)")
    return p.parse_args(argv)


def benchmark_clouds(batch_size: int, points: int) -> np.ndarray:
    """JAX's harness clouds [B, P, 5] f32."""
    rng = np.random.RandomState(0)
    pts = np.zeros((batch_size, points, 5), np.float32)
    pts[..., 0] = rng.uniform(-50, 50, (batch_size, points))
    pts[..., 1] = rng.uniform(-50, 50, (batch_size, points))
    pts[..., 2] = rng.uniform(-4.9, 2.9, (batch_size, points))
    return pts


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"


def main(argv=None) -> dict:
    """Prints the harness's lines; returns {"ms_per_iter", "scans_per_s",
    "device_ms" (None on the CPU), "predicts"}."""
    from ..device import resolve_device
    from ..models.builder import build_detector
    from ..runtime.steps import make_predict_step
    from ..utils.config import Config
    from .get_flops import is_bevfusion

    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    cfg = Config.fromfile(args.config)
    if is_bevfusion(cfg):
        raise ValueError(f"{args.config}: a BEVFusion config; the harness times CBGS configs "
                         "through build_detector, as JAX's tools/benchmark.py does")
    B, P = args.batch_size, args.points
    predict = make_predict_step(build_detector(cfg, device=device))
    batch = {"points": torch.from_numpy(benchmark_clouds(B, P)).to(device),
             "points_valid": torch.ones((B, P), dtype=torch.bool, device=device)}
    for _ in range(args.warmup):
        float(predict(batch)["scores"].sum())
    on_card = device.type == "cuda"
    events = []
    t0 = time.perf_counter()
    for _ in range(args.iters):
        if on_card:
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
        out = predict(batch)
        if on_card:
            end.record()
            events.append((start, end))
        float(out["scores"].sum())
    dt = (time.perf_counter() - t0) / args.iters
    print(f"batch {B}: {dt * 1e3:.1f} ms/iter -> {B / dt:.2f} scans/s")
    device_ms = None
    if on_card:
        device_ms = float(np.median([s.elapsed_time(e) for s, e in events]))
        print(f"device: median {device_ms:.3f} ms a predict between CUDA events over "
              f"{args.iters} timed predicts | {card_line()}")
    return dict(ms_per_iter=dt * 1e3, scans_per_s=B / dt, device_ms=device_ms,
                predicts=args.warmup + args.iters)


if __name__ == "__main__":
    main()
