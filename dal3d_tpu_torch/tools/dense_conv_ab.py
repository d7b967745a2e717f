#!/usr/bin/env python
"""The dense engine's 3D convs (ops/dense_sparse.py) at the CBGS
backbone's full-width shapes, timed on the card in two memory layouts and
two ways of picking cuDNN's algorithm.

    python -m dal3d_tpu_torch.tools.dense_conv_ab --choice heuristic|autotune \
        [--layouts ndhwc ncdhw] [--batch 2] [--levels 0 1 2 3]

For each conv of the backbone (configs/cbgs_spatial_temporal.py: sparse
shape (41, 1024, 1024); the stem, a submanifold conv and the downsample at
L0, a submanifold conv and the downsample at L1-L3), f32 with TF32 off, on
random inputs:

- layout ``ndhwc``: the engine's logical [B, D, H, W, C] tensor handed to
  ``F.conv3d`` as its ``channels_last_3d`` view; ``ncdhw``: the same values
  contiguous in [B, C, D, H, W];
- choice ``heuristic``: ``torch.backends.cudnn.benchmark`` off (cuDNN's
  heuristic); ``autotune``: on (the first call times the candidates). One
  choice a process: PyTorch caches a conv's plan by its shapes and layouts,
  not by the choice, so a second choice in the same process would reuse
  the first one's plans.

Per (conv, layout, choice): the first forward + backward's ms (host clock,
synchronized: it holds the autotuner's trials), then the forward, the input
gradient and the weight gradient alone, device ms per call
(``chip_smoke.cuda_time_ms``). Prints the card's name and power limit and a
JSON summary as the last line. Needs the card."""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[2]

# (level, name, Cin, Cout, kernel, stride, padding) of the backbone's convs
CONVS = [
    (0, "stem", 5, 16, (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    (0, "subm", 16, 16, (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    (0, "down", 16, 32, (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    (1, "subm", 32, 32, (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    (1, "down", 32, 64, (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    (2, "subm", 64, 64, (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    (2, "down", 64, 128, (3, 3, 3), (2, 2, 2), (0, 1, 1)),
    (3, "subm", 128, 128, (3, 3, 3), (1, 1, 1), (1, 1, 1)),
    (3, "down", 128, 128, (3, 1, 1), (2, 1, 1), (0, 0, 0)),
]
LEVEL_SHAPES = [(41, 1024, 1024), (21, 512, 512), (11, 256, 256), (5, 128, 128)]


def run_case(x, w, stride, padding, g, cuda_time_ms) -> dict:
    """First forward + backward ms, then steady device ms of each part."""
    xr = x.detach().requires_grad_(True)
    wr = w.detach().requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = F.conv3d(xr, wr, stride=stride, padding=padding)
    out.backward(g)
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    del out, xr, wr

    def fwd():
        return F.conv3d(x, w, stride=stride, padding=padding)

    def dgrad():
        return torch.ops.aten.convolution_backward(
            g, x, w, None, list(stride), list(padding), [1, 1, 1], False, [0, 0, 0], 1,
            [True, False, False])

    def wgrad():
        return torch.ops.aten.convolution_backward(
            g, x, w, None, list(stride), list(padding), [1, 1, 1], False, [0, 0, 0], 1,
            [False, True, False])

    return dict(first_ms=first, fwd_ms=cuda_time_ms(fwd, 2), dgrad_ms=cuda_time_ms(dgrad, 2),
                wgrad_ms=cuda_time_ms(wgrad, 2))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--levels", type=int, nargs="*", default=[0, 1, 2, 3])
    ap.add_argument("--layouts", nargs="*", default=["ndhwc", "ncdhw"])
    ap.add_argument("--choice", choices=["heuristic", "autotune"], required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("dense_conv_ab: needs the card")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import cuda_time_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, cuDNN {torch.backends.cudnn.version()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for level, name, cin, cout, k, s, p in CONVS:
        if level not in args.levels:
            continue
        D, H, W = LEVEL_SHAPES[level]
        Do, Ho, Wo = ((n + 2 * p_ - k_) // s_ + 1 for n, k_, s_, p_ in zip((D, H, W), k, s, p))
        base = torch.randn(args.batch, D, H, W, cin, device="cuda", generator=gen)
        wbase = torch.randn(*k, cin, cout, device="cuda", generator=gen) * 0.05
        gbase = torch.randn(args.batch, Do, Ho, Wo, cout, device="cuda", generator=gen)
        for layout in args.layouts:
            if layout == "ndhwc":
                x = base.permute(0, 4, 1, 2, 3)
                w = wbase.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
                g = gbase.permute(0, 4, 1, 2, 3)
            else:
                x = base.permute(0, 4, 1, 2, 3).contiguous()
                w = wbase.permute(4, 3, 0, 1, 2).contiguous()
                g = gbase.permute(0, 4, 1, 2, 3).contiguous()
            with torch.backends.cudnn.flags(enabled=True, benchmark=args.choice == "autotune",
                                            deterministic=False, allow_tf32=False):
                r = run_case(x, w, s, p, g, cuda_time_ms)
            r.update(level=level, conv=name, layout=layout, choice=args.choice)
            rows.append(r)
            print(f"L{level} {name} {cin}->{cout} k{k} s{s} p{p} {layout} {args.choice}: first "
                  f"fwd+bwd {r['first_ms']:.1f} ms; fwd {r['fwd_ms']:.3f} dgrad "
                  f"{r['dgrad_ms']:.3f} wgrad {r['wgrad_ms']:.3f} ms", flush=True)
            del x, w, g
        del base, wbase, gbase
        torch.cuda.empty_cache()
    print(json.dumps({"card": smi, "batch": args.batch, "choice": args.choice, "rows": rows}))


if __name__ == "__main__":
    main()
