#!/usr/bin/env python
"""This tree's gather-GEMM (K4: the forward and input-gradient launches),
weight-gradient kernel (K4-dW) and assignment kernel (LSA) against another
tree's, on the inputs of one full-width train step, timed in turns on the
card.

    python -m dal3d_tpu_torch.tools.kernel_ab --other <dir> [--rounds 1]
        [--dtype float32|bfloat16]

``<dir>`` holds another tree's ``dal3d_tpu_torch`` package, for example a
parent commit unpacked by ``git archive <commit> dal3d_tpu_torch | tar -x
-C <dir>``. It is imported under another name and its kernels are built
from its own sources into a temporary directory; its wrappers keep their
own launch parameters (the dW kernel's chunk shares).

``--dtype float32`` (the default) takes the inputs of phase 18 of
``chip_smoke.py``: configs/bevfusion_lidar.py at full width, that phase's
seeded clouds and GT boxes, weights from seed 0; one train step runs with
its 41 f32 K4 launches, 21 dW launches and the assignment's cost captured.
``--dtype bfloat16`` takes those of phase 23: configs/cbgs_spatial_temporal.py
on the gather engine in bf16 at full width (phase 21's voxels, its seed-0
f32 weights cast, phase 23's GT boxes); one train step with its 41 bf16 K4
launches (21 forward, 20 input gradients) and 21 bf16 dW launches, no
assignment. Each round times other, this, this, other: per turn the sum of
the K4 launches' (and of the 21 forward ones apart), the dW launches' and
the assignment's device times (``chip_smoke.cuda_time_ms``). The two
trees' results are held against each other: K4 and dW within 1e-5 (f32)
or 2^-7 (bf16, one ulp) of each launch's scale (and whether every launch
gives the same bits is printed), ``col4row`` equal. Prints the card's name
and power limit, a line per turn, a line per K4 and per dW launch (the mean
of each side's turns) and a JSON summary as the last line. Needs the card.
"""
import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]


def load_other(root: Path, build_dir: Path):
    """(gather, lsa) modules of the package under ``root``, imported as
    ``other_port``, its kernels built into ``build_dir``."""
    pkg = root / "dal3d_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "other_port", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_port"] = mod
    spec.loader.exec_module(mod)
    importlib.import_module("other_port.ops._build").BUILD_DIR = build_dir
    return (importlib.import_module("other_port.ops.gather"),
            importlib.import_module("other_port.ops.lsa"))


def captured_step(cs):
    """The K4 launches' (features, plan, weights), the dW launches'
    (features, plan, g) and the assignment's cost of one full-width
    BEVFusion train step (phase 18's inputs)."""
    from dal3d_tpu_torch.models.builder import bevfusion_optimizer, build_bevfusion
    from dal3d_tpu_torch.ops import gather as tg
    from dal3d_tpu_torch.ops import lsa as tl
    from dal3d_tpu_torch.runtime.bevfusion_steps import make_bevfusion_train_step
    from dal3d_tpu_torch.utils.config import Config

    cfg = Config.fromfile(str(ROOT / "configs" / "bevfusion_lidar.py"))
    batch, _, _ = cs.bevfusion_batch(10, cfg)
    batch["gt_boxes"], batch["gt_classes"] = cs.bevfusion_gt(18)
    bundle = build_bevfusion(cfg, seed=0)
    step = make_bevfusion_train_step(bundle, bevfusion_optimizer(cfg, bundle, 100))
    with cs.Capture(tg, "_launch_gemm") as k4, cs.Capture(tg, "_launch_dw") as kdw, \
            cs.Capture(tl, "linear_sum_assignment") as klsa:
        step(batch)
        torch.cuda.synchronize()
    return k4.calls, kdw.calls, klsa.calls[0][0]


def captured_bf16_step(cs):
    """The bf16 K4 launches' (features, plan, weights) and the bf16 dW
    launches' (features, plan, g) of one full-width bf16 CBGS gather train
    step (phase 23's inputs), and no assignment."""
    from dal3d_tpu_torch.models.builder import build_detector
    from dal3d_tpu_torch.ops import gather as tg
    from dal3d_tpu_torch.runtime.steps import make_train_step
    from dal3d_tpu_torch.solver.optim import OneCycleSchedule, build_optimizer
    from dal3d_tpu_torch.utils.config import Config

    f32 = cs.engine_cfg(Config, "gather", dtype="float32", voxel_caps=cs.GATHER_CAPS)
    sd = {k: v.cpu().clone() for k, v in build_detector(f32, seed=0).model.state_dict().items()}
    cfg = cs.engine_cfg(Config, "gather", dtype="bfloat16", voxel_caps=cs.GATHER_CAPS)
    bundle = cs.engine_bundle(cfg, sd)
    vf, vc, vv, _ = cs.make_batch(0, cfg)
    gt = cs.random_gt(cfg, np.random.RandomState(23), cs.B, 8, 45.0)
    batch = {"voxel_features": torch.from_numpy(vf), "voxel_coords": torch.from_numpy(vc),
             "voxel_valid": torch.from_numpy(vv), "gt_boxes": gt[0], "gt_classes": gt[1]}
    opt = build_optimizer(OneCycleSchedule(total_steps=100)).init(bundle.model.named_parameters())
    step = make_train_step(bundle, opt)
    with cs.Capture(tg, "_launch_gemm") as k4, cs.Capture(tg, "_launch_dw") as kdw:
        step(batch)
        torch.cuda.synchronize()
    if any(c[0].dtype != torch.bfloat16 for c in k4.calls + kdw.calls):
        raise RuntimeError("kernel_ab: the bf16 train step launched an f32 kernel")
    return k4.calls, kdw.calls, None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="directory holding the other dal3d_tpu_torch")
    ap.add_argument("--rounds", type=int, default=1, help="rounds of other, this, this, other")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                    help="the f32 BEVFusion step (K4, dW, LSA) or the bf16 CBGS gather step")
    args = ap.parse_args(argv)
    bf16 = args.dtype == "bfloat16"
    tol = 2.0 ** -7 if bf16 else 1e-5
    if not torch.cuda.is_available():
        print("kernel_ab: needs the CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    from dal3d_tpu_torch.ops import gather as tg
    from dal3d_tpu_torch.ops import lsa as tl

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {torch.cuda.get_device_name(0)} | {smi}")
    with tempfile.TemporaryDirectory() as tmp:
        og, ol = load_other(Path(args.other).resolve(), Path(tmp))
        k4_calls, dw_calls, cost = (captured_bf16_step if bf16 else captured_step)(cs)
        sides = {"this": (tg, tl), "other": (og, ol)}
        same_bits = True
        for what, fn, calls in (("K4", "_launch_gemm", k4_calls), ("dW", "_launch_dw", dw_calls)):
            for n, call in enumerate(calls):
                a, b = getattr(tg, fn)(*call).float(), getattr(og, fn)(*call).float()
                scale = max(float(b.abs().max()), 1e-30)
                if not float((a - b).abs().max()) <= tol * scale:
                    print(f"kernel_ab: {what} launch {n} differs between the trees",
                          file=sys.stderr)
                    return 1
                same_bits &= torch.equal(a, b)
        print(f"the two trees' {len(k4_calls)} K4 and {len(dw_calls)} dW launches ({args.dtype}): "
              f"within {tol:.2e} of scale; the same bits: {same_bits}")
        if cost is not None and not torch.equal(tl.linear_sum_assignment(cost),
                                                ol.linear_sum_assignment(cost)):
            print("kernel_ab: col4row differs between the trees", file=sys.stderr)
            return 1
        turns = {"this": [], "other": []}
        per_launch = {"this": [], "other": []}
        per_k4 = {"this": [], "other": []}
        n_fwd = len(dw_calls)  # a train step's forward launches come first, one per dW
        for r in range(args.rounds):
            for side in ("other", "this", "this", "other"):
                gm, lm = sides[side]
                k4 = [cs.cuda_time_ms(lambda f=f, p=p, w=w: gm._launch_gemm(f, p, w), 5)
                      for f, p, w in k4_calls]
                ms = [cs.cuda_time_ms(lambda f=f, p=p, g=g: gm._launch_dw(f, p, g), 5)
                      for f, p, g in dw_calls]
                lsa_ms = (cs.cuda_time_ms(lambda: lm.linear_sum_assignment(cost), 5)
                          if cost is not None else float("nan"))
                turns[side].append((sum(ms), lsa_ms, sum(k4), sum(k4[:n_fwd])))
                per_launch[side].append(ms)
                per_k4[side].append(k4)
                print(f"round {r} {side:5s}: K4 {sum(k4):.3f} ms over {len(k4)} launches (the "
                      f"{n_fwd} forward {sum(k4[:n_fwd]):.3f}), K4-dW {sum(ms):.3f} ms over "
                      f"{len(ms)} launches, LSA {lsa_ms:.4f} ms")
    mean = {s: np.mean(per_launch[s], axis=0) for s in per_launch}
    mean4 = {s: np.mean(per_k4[s], axis=0) for s in per_k4}
    for n, (f, plan, w) in enumerate(k4_calls):
        print(f"  K4 #{n:2d} Cin {f.shape[-1]:3d} Cout {w.shape[-1]:3d} taps "
              f"{plan.rulebook.shape[1]:2d} hits {int((plan.rulebook >= 0).sum()):8d}: this "
              f"{mean4['this'][n]:.4f} ms, other {mean4['other'][n]:.4f} ms")
    for n, (f, plan, g) in enumerate(dw_calls):
        print(f"  dW #{n:2d} Cin {f.shape[-1]:3d} Cout {g.shape[-1]:3d} taps "
              f"{plan.rulebook.shape[1]:2d} hits {int((plan.rulebook >= 0).sum()):8d}: this "
              f"{mean['this'][n]:.4f} ms, other {mean['other'][n]:.4f} ms")
    summary = {s: {"k4_ms": [t[2] for t in turns[s]], "k4_forward_ms": [t[3] for t in turns[s]],
                   "dw_ms": [t[0] for t in turns[s]],
                   "lsa_ms": [t[1] for t in turns[s]] if not bf16 else None} for s in turns}
    summary["dtype"] = args.dtype
    summary["same_bits"] = same_bits
    summary["card"] = smi
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
