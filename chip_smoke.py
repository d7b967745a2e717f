#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (dal3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, CBGS FPNVoxelNet predict
(configs/cbgs_spatial_temporal.py: banded bf16 backbone, RPN, 6-group head,
top-k + decode + rotated-IoU NMS) at full width on B=2 lidar-like clouds of
250k points voxelized on the host (mean features, <= 60000 voxels, bf16),
with seeded random weights. Phases, each fatal on failure:

  1. versions of torch / CUDA / nvcc and the card (nvidia-smi);
  2. builds every kernel from the sources in this checkout (one nvcc per
     source, all started together);
  3. captures the inputs of every kernel launch of one predict and holds each
     launch against the kernel's plain PyTorch version on the same inputs;
     times kernel, plain version and a PyTorch yardstick (index_select +
     matmul for the banded gather-GEMM) at those shapes;
  4. the same predict in f32 on a small grid, on the card and on the CPU
     (plain versions): detections equal as sets;
  5. the main path: launch counters set to 0, a warm-up and 10 timed
     predicts, counters read; outputs checked (shapes, finite); the BEV map,
     embedding and head maps held against the same forward with every kernel
     swapped for its plain version; per-stage split and peak memory.

Prints a ``kernels`` JSON line, the nvidia-smi line, and as its last line
``{"ok": true, "device": {...}}``. Exits nonzero, printing no result, when no
GPU is present or the port cannot be imported.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# NVIDIA H100 SXM data sheet (dense): bf16 tensor cores, f32 outside the
# tensor cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# f32 operations per (i, j) pair of the IoU kernel: 2 directions x 4 edges x
# (4 planes x 12 + 18 per-edge clip / cross / accumulate), plus the final 8
IOU_OPS_PER_PAIR = 2 * 4 * (4 * 12 + 18) + 8
K1_PER_PREDICT = 42  # L0: 5 subm x (pad + conv) + ds1 x 2; stages 1-3: 4 x 2 + 2 each
K2_PER_PREDICT = 1
TIMED_ITERS = 10
B, POINTS, MAX_VOXELS = 2, 250_000, 60000


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def lidar_cloud(rng, n_points=POINTS) -> np.ndarray:
    """Lidar-like cloud: radial ground rings dense near the ego, vertical
    wall segments and box-shaped object clusters (the clustering of a
    10-sweep nuScenes frame, as the JAX package's tools/microbench.py)."""
    n_ground = int(n_points * 0.55)
    az = rng.uniform(-np.pi, np.pi, n_ground)
    r = 2.0 + 48.0 * rng.power(2.2, n_ground)
    ground = np.stack([r * np.cos(az), r * np.sin(az),
                       rng.normal(-1.8, 0.05, n_ground) + r * 0.003], 1)
    n_wall = int(n_points * 0.3)
    seg = rng.randint(0, 40, n_wall)
    saz = rng.uniform(-np.pi, np.pi, 40)[seg] + rng.normal(0, 0.02, n_wall)
    sr = rng.uniform(8, 50, 40)[seg] + rng.normal(0, 0.3, n_wall)
    wall = np.stack([sr * np.cos(saz), sr * np.sin(saz), rng.uniform(-1.8, 2.8, n_wall)], 1)
    n_obj = n_points - n_ground - n_wall
    oc = rng.uniform(-45, 45, (25, 2))
    oi = rng.randint(0, 25, n_obj)
    obj = np.stack([oc[oi, 0] + rng.uniform(-2.2, 2.2, n_obj),
                    oc[oi, 1] + rng.uniform(-1.0, 1.0, n_obj),
                    rng.uniform(-1.8, 0.2, n_obj)], 1)
    p = np.concatenate([ground, wall, obj], 0).astype(np.float32)
    keep = (np.abs(p[:, 0]) < 51.2) & (np.abs(p[:, 1]) < 51.2) & (p[:, 2] > -5) & (p[:, 2] < 3)
    return p[keep]


def voxelize(points: np.ndarray, voxel_size, pc_range, max_points: int, max_voxels: int):
    """Mean-feature voxelization: voxels in first-appearance order, at most
    ``max_voxels`` of them, the first ``max_points`` points of each averaged.
    Returns features [V, F] f32, coords [V, 3] int32 (z, y, x)."""
    vs, r0 = np.asarray(voxel_size, np.float32), np.asarray(pc_range[:3], np.float32)
    grid = np.round((np.asarray(pc_range[3:]) - np.asarray(pc_range[:3])) / vs).astype(np.int64)
    c = np.floor((points[:, :3] - r0) / vs).astype(np.int64)
    ok = np.all((c >= 0) & (c < grid), axis=1)
    points, c = points[ok], c[ok]
    lin = (c[:, 2] * grid[1] + c[:, 1]) * grid[0] + c[:, 0]
    _, first, inv = np.unique(lin, return_index=True, return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    vid = rank[inv]  # voxel id in first-appearance order
    order = np.argsort(vid, kind="stable")
    starts = np.searchsorted(vid[order], np.arange(len(first)))
    slot = np.empty(len(vid), np.int64)
    slot[order] = np.arange(len(vid)) - starts[vid[order]]
    take = (slot < max_points) & (vid < max_voxels)
    nv = min(len(first), max_voxels)
    feats = np.zeros((nv, points.shape[1]), np.float64)
    np.add.at(feats, vid[take], points[take])
    cnt = np.bincount(vid[take], minlength=nv)[:nv]
    coords = c[np.sort(first)[:nv]][:, ::-1].astype(np.int32)  # voxel v's first point
    return (feats / np.maximum(cnt, 1)[:, None]).astype(np.float32), coords


def make_batch(seed: int, cfg):
    """B clouds -> host voxels [B, 60000, ...]. Points stay in generation
    order (ground, walls, objects), as the JAX package's bench.py feeds them,
    so the first 60000 voxels are mostly ground: 41k L0 bricks, inside the
    48000 cap (a shuffled cloud overflows it)."""
    vg = cfg["voxel_generator"]
    rng = np.random.RandomState(seed)
    vf = np.zeros((B, MAX_VOXELS, 5), np.float32)
    vc = np.zeros((B, MAX_VOXELS, 3), np.int32)
    vv = np.zeros((B, MAX_VOXELS), bool)
    n_vox = []
    for b in range(B):
        p = lidar_cloud(rng)
        pts = np.concatenate([p, rng.uniform(0, 255, (len(p), 1)).astype(np.float32),
                              np.zeros((len(p), 1), np.float32)], 1)
        f, c = voxelize(pts, vg["voxel_size"], vg["range"], vg["max_points_in_voxel"],
                        MAX_VOXELS)
        vf[b, :len(f)], vc[b, :len(f)], vv[b, :len(f)] = f, c, True
        n_vox.append(len(f))
    return vf, vc, vv, n_vox


def cuda_time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def library_banded(table, idx, w):
    """Yardstick the port never calls: one index_select of every (row, tap)
    then one cuBLAS matmul [B*M, Q*R] x [Q*R, Rout]."""
    Bt, Mb, R = table.shape
    Q, M = idx.shape[1], idx.shape[2]
    flat = torch.cat([table.reshape(Bt * Mb, R), table.new_zeros(1, R)])
    base = (torch.arange(Bt, device=idx.device) * Mb)[:, None, None]
    sel = torch.where(idx >= 0, idx.long() + base, Bt * Mb).permute(0, 2, 1).reshape(-1)
    wf = w.reshape(Q * R, -1)

    def run():
        g = flat.index_select(0, sel).view(Bt * M, Q * R)
        return torch.matmul(g, wf).view(Bt, M, -1)

    return run


def banded_bound_ms(table, idx, w) -> tuple:
    """(bound ms, "bytes" | "operations") of one banded launch: each input
    read once, the output written once; 2 * hits * R * Rout operations."""
    Bt, Mb, R = table.shape
    Q, M = idx.shape[1], idx.shape[2]
    Rout = w.shape[-1]
    es = table.element_size()
    nbytes = Bt * Mb * R * es + idx.numel() * 4 + w.numel() * es + Bt * M * Rout * es
    hits = int((idx >= 0).sum())
    peak = PEAK_BF16 if es == 2 else PEAK_F32
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, 2.0 * hits * R * Rout / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def iou_bound_ms(rows, cols) -> tuple:
    G, N, _ = rows.shape
    M = cols.shape[1]
    nbytes = (rows.numel() + cols.numel() + G * N * M) * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = G * N * M * IOU_OPS_PER_PAIR / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Capture:
    """Records the inputs of every launch of a kernel wrapper (by swapping
    the module attribute the callers look up) for the hold-against-plain and
    timing phases; the launches it wraps still run the kernel."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.calls = []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def spy(*args):
            self.calls.append(tuple(a.clone() for a in args))
            return self.orig(*args)

        # the wrapper counts on the module attribute it is looked up by
        spy.launches = self.orig.launches
        self.spy = spy
        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        self.orig.launches = self.spy.launches
        setattr(self.module, self.name, self.orig)


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    try:
        from dal3d_tpu_torch.models.builder import build_detector
        from dal3d_tpu_torch.models.heads.mg_head import multi_group_predict
        from dal3d_tpu_torch.ops import _build
        from dal3d_tpu_torch.ops import banded as bd
        from dal3d_tpu_torch.ops import iou_matrix as tiou
        from dal3d_tpu_torch.ops.nms import greedy_nms_from_iou
        from dal3d_tpu_torch.runtime.steps import make_predict_step
        from dal3d_tpu_torch.utils.config import Config
    except ImportError as e:
        fail(f"cannot import the port (run from a checkout of the repo): {e}")
    dev = torch.device("cuda")

    # 1. versions -----------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    nv = subprocess.run([_build.nvcc(), "--version"], capture_output=True, text=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc {nv.stdout.strip().splitlines()[-1] if nv.returncode == 0 else '?'}")
    print(f"card: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | {smi_line}")

    # 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(built)} kernels "
          f"({' '.join(_build.ARCH_FLAGS)})")
    for name, (sec, log) in built.items():
        info = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln.lower()]
        print(f"  {name}: {sec:.1f} s; " + " | ".join(info[-4:]))

    # model + inputs ----------------------------------------------------------
    cfg = Config.fromfile(os.path.join(ROOT, "configs", "cbgs_spatial_temporal.py"))
    t0 = time.perf_counter()
    vf, vc, vv, n_vox = make_batch(0, cfg)
    print(f"inputs: B={B}, {POINTS} points/cloud -> voxels {n_vox} "
          f"({time.perf_counter() - t0:.1f} s host voxelization)")
    batch = {"voxel_features": torch.from_numpy(vf).to(torch.bfloat16),
             "voxel_coords": torch.from_numpy(vc), "voxel_valid": torch.from_numpy(vv)}
    bundle = build_detector(cfg, seed=0)
    predict = make_predict_step(bundle)
    print(f"model: {sum(p.numel() for p in bundle.model.parameters())} parameters, "
          f"backbone {bundle.model.backbone.l0.stem.dtype}, caps {bundle.model.backbone.caps}, "
          f"widths {bundle.model.backbone.widths}")

    # 3. every launch of one predict against the plain version ---------------
    with Capture(bd, "banded_conv") as k1, Capture(tiou, "iou_matrix") as k2:
        predict(batch)
        torch.cuda.synchronize()
    if len(k1.calls) != K1_PER_PREDICT or len(k2.calls) != K2_PER_PREDICT:
        fail(f"capture run launched banded_conv {len(k1.calls)}x, iou_matrix "
             f"{len(k2.calls)}x; expected {K1_PER_PREDICT} and {K2_PER_PREDICT}")
    k1_err, k1_rows = 0.0, []
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, t_bytes=0.0, t_ops=0.0)
    for n, (table, idx, w) in enumerate(k1.calls):
        got = bd.banded_conv(table, idx, w).float()
        ref = bd.banded_conv_plain(table, idx, w).float()
        err = float((got - ref).abs().max())
        tol = 2.0 ** -7 * max(float(ref.abs().max()), 1e-30)  # one bf16 ulp at the output's scale
        if not err <= tol:
            fail(f"banded_conv launch {n} {tuple(table.shape)}x{tuple(w.shape)}: "
                 f"max_abs_err {err:.3e} > {tol:.3e}")
        k1_err = max(k1_err, err / max(float(ref.abs().max()), 1e-30))
        ms = cuda_time_ms(lambda: bd.banded_conv(table, idx, w), 5)
        pms = cuda_time_ms(lambda: bd.banded_conv_plain(table, idx, w), 2)
        lms = cuda_time_ms(library_banded(table, idx, w), 2)
        bms, by = banded_bound_ms(table, idx, w)
        tot["ms"] += ms
        tot["plain_ms"] += pms
        tot["library_ms"] += lms
        tot["bound_ms"] += bms
        tot["t_" + ("bytes" if by == "bytes" else "ops")] += bms
        k1_rows.append((n, tuple(table.shape), tuple(idx.shape), tuple(w.shape),
                        int((idx >= 0).sum()), err, tol, ms, pms, lms, bms, by))
    print("banded_conv launches of one predict (kernel vs plain, bf16; tol = 2^-7 x max|plain|):")
    for n, ts, ish, ws, hits, err, tol, ms, pms, lms, bms, by in k1_rows:
        print(f"  #{n:2d} table {ts} idx {ish} w {ws} hits {hits}: err {err:.2e} (tol {tol:.2e}) "
              f"kernel {ms:.4f} ms plain {pms:.3f} ms library {lms:.4f} ms bound {bms:.4f} ms ({by})")
    k1_abs = max(r[5] for r in k1_rows)
    print(f"banded_conv per predict: kernel {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, "
          f"library {tot['library_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms; "
          f"max_abs_err {k1_abs:.3e} (max relative to output scale {k1_err:.2e})")

    rows, cols = k2.calls[0]
    got, ref = tiou.iou_matrix(rows, cols), tiou.iou_matrix_plain(rows, cols)
    k2_err = float((got - ref).abs().max())
    if not k2_err <= 1e-5:
        fail(f"iou_matrix main-path input {tuple(rows.shape)}: max_abs_err {k2_err:.3e} > 1e-5")
    # synthetic [12, 1000, 1000] with identical, disjoint and coincident-edge pairs
    rng = np.random.RandomState(1)
    bx = np.zeros((12, 1000, 5), np.float32)
    bx[..., :2] = rng.uniform(-50, 50, (12, 1000, 2))
    bx[..., 2:4] = rng.uniform(0.4, 12.0, (12, 1000, 2))
    bx[..., 4] = rng.uniform(-np.pi, np.pi, (12, 1000))
    bx[:, 500:600] = bx[:, 400:500]  # identical
    bx[:, 600:608] = [[0.5, 0.5, 1, 1, 0], [1.5, 0.5, 1, 1, 0], [1.0, 0.5, 1, 1, 0],
                      [1.0, 0.5, 2, 1, 0], [0.0, 0.0, 1, 1, np.pi / 4],
                      [np.cos(np.pi / 4), np.cos(np.pi / 4), 1, 1, np.pi / 4],
                      [60.0, 60.0, 2, 4, 1.0], [0, 0, 0, 0, 0]]  # coincident, disjoint, zero
    srec = tiou._pack_rowdat(torch.from_numpy(bx).to(dev))
    sgot, sref = tiou.iou_matrix(srec, srec), tiou.iou_matrix_plain(srec, srec)
    s_err = float((sgot - sref).abs().max())
    checks = [float(sgot[0, 500, 400]), float(sgot[0, 600, 601]), float(sgot[0, 600, 602]),
              float(sgot[0, 604, 605]), float(sgot[0, 606, 0]), float(sgot[0, 607].abs().max())]
    want = [1.0, 0.0, 1.0 / 3.0, 0.0, 0.0, 0.0]
    if not s_err <= 1e-5 or not np.allclose(checks, want, atol=1e-3):
        fail(f"iou_matrix synthetic [12,1000,1000]: max_abs_err {s_err:.3e}, pairs {checks} vs {want}")
    k2_err = max(k2_err, s_err)
    k2_ms = cuda_time_ms(lambda: tiou.iou_matrix(rows, cols), 20)
    k2_plain = cuda_time_ms(lambda: tiou.iou_matrix_plain(rows, cols), 3)
    k2_bound, k2_by = iou_bound_ms(rows, cols)
    print(f"iou_matrix {tuple(rows.shape)}: max_abs_err {k2_err:.2e} (tol 1e-05) kernel {k2_ms:.4f} ms "
          f"plain {k2_plain:.3f} ms bound {k2_bound:.4f} ms ({k2_by}); synthetic pairs {checks}")

    # 4. small f32 predict: card (kernels) vs CPU (plain versions) -------------
    small = small_f32_parity(Config, build_detector, make_predict_step)
    print(f"small f32 predict, card vs CPU: {small}")

    # 5. the main path ----------------------------------------------------------
    bd.banded_conv.launches = 0
    tiou.iou_matrix.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = predict(batch)  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_ITERS):
        t0 = time.perf_counter()
        out = predict(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    n_runs = TIMED_ITERS + 1
    k1_launches, k2_launches = bd.banded_conv.launches, tiou.iou_matrix.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if k1_launches != K1_PER_PREDICT * n_runs or k2_launches != K2_PER_PREDICT * n_runs:
        fail(f"main path launched banded_conv {k1_launches}x, iou_matrix {k2_launches}x in "
             f"{n_runs} predicts; expected {K1_PER_PREDICT} and {K2_PER_PREDICT} per predict")
    shapes = {"box3d_lidar": (B, 498, 9), "scores": (B, 498), "label_preds": (B, 498),
              "det_valid": (B, 498), "embedding": (B, 512), "score_entropy": (B,)}
    for k, shp in shapes.items():
        if tuple(out[k].shape) != shp:
            fail(f"output {k} has shape {tuple(out[k].shape)}, expected {shp}")
        if out[k].is_floating_point() and not bool(torch.isfinite(out[k]).all()):
            fail(f"output {k} is not finite")
    n_det = [int(x) for x in out["det_valid"].sum(1)]
    if min(n_det) == 0:
        fail(f"no detections: {n_det}")
    ms_med = float(np.median(times))
    print(f"predict (B={B}): median {ms_med:.2f} ms, mean {np.mean(times):.2f} ms, "
          f"min {min(times):.2f} ms over {TIMED_ITERS} iterations -> {B / ms_med * 1e3:.2f} scans/s; "
          f"peak memory {peak_gb:.2f} GB; detections {n_det}; launches banded_conv "
          f"{k1_launches} iou_matrix {k2_launches} in {n_runs} predicts")
    e2e = plain_reference_check(bd, tiou, bundle, predict, batch, out)
    print(f"main path vs the same path on plain versions: {e2e}")
    stage_split(bundle, batch, multi_group_predict, greedy_nms_from_iou, tiou)
    device_profile(predict, batch, ms_med)

    # 6. kernels line, card line, result --------------------------------------
    kernels = [
        dict(name="banded_conv", route="cuda", source="dal3d_tpu_torch/ops/csrc/banded_conv.cu",
             replaces="dal3d_tpu/ops/banded.py:282", launches=k1_launches,
             max_abs_err=k1_abs, ms=tot["ms"], plain_ms=tot["plain_ms"],
             bound_ms=tot["bound_ms"],
             bound_by="bytes" if tot["t_bytes"] >= tot["t_ops"] else "operations",
             library_ms=tot["library_ms"]),
        dict(name="iou_matrix", route="cuda", source="dal3d_tpu_torch/ops/csrc/iou_matrix.cu",
             replaces="dal3d_tpu/ops/pallas_iou.py:133", launches=k2_launches,
             max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain, bound_ms=k2_bound,
             bound_by=k2_by, library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def small_f32_parity(Config, build_detector, make_predict_step) -> str:
    """f32 predict on a 12.8 m grid (sparse shape (41, 64, 64)), production
    widths: the card's kernels vs the CPU's plain versions must give the same
    detections (sets) and embeddings within 1e-4."""
    cfg = Config.fromfile(os.path.join(ROOT, "configs", "cbgs_spatial_temporal.py"))
    cfg["voxel_generator"].update(range=[-6.4, -6.4, -5.0, 6.4, 6.4, 3.0],
                                  voxel_size=[0.2, 0.2, 0.2])
    for g in cfg["target_assigner"]["anchor_generators"]:
        z = g["anchor_ranges"][2]
        g["anchor_ranges"] = [-6.4, -6.4, z, 6.4, 6.4, z]
    cfg["model"]["backbone"].update(dtype="float32", brick_widths=(8, 8, 8, 4, 4),
                                    banded_caps=(1536, 1536, 768, 384, 384))
    cfg["test_cfg"]["nms"].update(nms_pre_max_size=64, nms_post_max_size=16)
    rng = np.random.RandomState(2)
    pts = rng.uniform([-6.4, -6.4, -3.0, 0, 0], [6.4, 6.4, 1.0, 255, 0], (20000, 5)).astype(np.float32)
    f, c = voxelize(pts, cfg["voxel_generator"]["voxel_size"], cfg["voxel_generator"]["range"],
                    10, 1500)
    batch = {"voxel_features": f[None], "voxel_coords": c[None],
             "voxel_valid": np.ones((1, len(f)), bool)}
    outs = {}
    for d in ("cpu", "cuda"):
        o = make_predict_step(build_detector(cfg, device=d, seed=1))(batch)
        outs[d] = {k: v.float().cpu() for k, v in o.items()}
    a, b = outs["cpu"], outs["cuda"]
    emb = float((a["embedding"] - b["embedding"]).abs().max())
    va, vb = a["det_valid"][0] > 0, b["det_valid"][0] > 0
    if emb > 1e-4 or int(va.sum()) != int(vb.sum()) or int(va.sum()) == 0:
        fail(f"small f32 predict: embedding err {emb:.2e}, detections {int(va.sum())} vs {int(vb.sum())}")
    box, sc, unmatched = match_dets(a, b, 0)
    if box > 1e-3 or sc > 1e-4 or unmatched:
        fail(f"small f32 predict: detections differ (box rel err {box:.2e}, score err {sc:.2e}, "
             f"{unmatched} unmatched)")
    return (f"{len(f)} voxels, {int(va.sum())} detections equal as sets (box rel err {box:.1e}, "
            f"score err {sc:.1e}), embedding err {emb:.1e}")


def match_dets(a, b, i: int):
    """Pairs the valid detections of sample i of two outputs one to one (same
    label, score within 1e-4, nearest center; scores may tie). Returns (max
    box error relative to max(1, |box|), max score error, unmatched count)."""
    va, vb = a["det_valid"][i] > 0, b["det_valid"][i] > 0
    ba, bb_ = a["box3d_lidar"][i][va].double(), b["box3d_lidar"][i][vb].double()
    sa, sb = a["scores"][i][va].double(), b["scores"][i][vb].double()
    la, lb = a["label_preds"][i][va], b["label_preds"][i][vb]
    used = set()
    box_err = sc_err = 0.0
    unmatched = abs(len(sa) - len(sb))
    for k in sorted(range(len(sa)), key=lambda k: -float(sa[k])):
        cand = [j for j in range(len(sb)) if j not in used and int(lb[j]) == int(la[k])
                and abs(float(sb[j] - sa[k])) <= 1e-4]
        if not cand:
            unmatched += 1
            continue
        j = min(cand, key=lambda j: float((bb_[j, :2] - ba[k, :2]).norm()))
        used.add(j)
        rel = (bb_[j] - ba[k]).abs() / torch.clamp(ba[k].abs(), min=1.0)
        box_err = max(box_err, float(rel.max()))
        sc_err = max(sc_err, abs(float(sb[j] - sa[k])))
    return box_err, sc_err, unmatched


def plain_reference_check(bd, tiou, bundle, predict, batch, out) -> str:
    """Runs the main path once more with each kernel wrapper swapped for its
    plain version (same weights, same inputs). The dense BEV map, the neck
    embedding and every head prediction must agree within 5e-2 of their
    scale: the two round the same f32 sums to bf16, in a different order,
    through 20 bf16 layers. Detections are only reported (matched: same
    label, center within 0.1 m, score within 0.02): with random weights the
    1000-candidate top-k sits among near-equal scores, so a last-bit
    difference reorders candidates and NMS."""
    dev = bundle.device

    def forward():
        with torch.inference_mode():
            return bundle.model(batch["voxel_features"].to(dev), batch["voxel_coords"].to(dev),
                                batch["voxel_valid"].to(dev))

    mk = forward()
    k1, k2 = bd.banded_conv, tiou.iou_matrix
    bd.banded_conv, tiou.iou_matrix = bd.banded_conv_plain, tiou.iou_matrix_plain
    try:
        mp = forward()
        ref = predict(batch)
        torch.cuda.synchronize()
    finally:
        bd.banded_conv, tiou.iou_matrix = k1, k2
    pairs = [("dense", mk["dense"], mp["dense"]), ("embedding", mk["embedding"], mp["embedding"])]
    for t, (pk, pp) in enumerate(zip(mk["preds"], mp["preds"])):
        pairs += [(f"box_preds[{t}]", pk["box_preds"], pp["box_preds"]),
                  (f"cls_preds[{t}]", pk["cls_preds"], pp["cls_preds"])]
    worst, report = 0.0, []
    for name, a, b in pairs:
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        worst = max(worst, rel)
        if name in ("dense", "embedding", "cls_preds[0]", "box_preds[0]"):
            report.append(f"{name} {rel:.2e}")
    found = total = 0
    for b in range(out["scores"].shape[0]):
        vk, vr = out["det_valid"][b], ref["det_valid"][b]
        bk, br = out["box3d_lidar"][b][vk], ref["box3d_lidar"][b][vr]
        sk, sr = out["scores"][b][vk], ref["scores"][b][vr]
        lk, lr = out["label_preds"][b][vk], ref["label_preds"][b][vr]
        total += len(sk)
        if len(sk) and len(sr):
            ok = ((torch.cdist(bk[:, :2], br[:, :2]) < 0.1) & (lk[:, None] == lr[None, :])
                  & ((sk[:, None] - sr[None, :]).abs() < 0.02))
            found += int(ok.any(1).sum())
    if worst > 5e-2:
        fail(f"main path vs plain path: max error relative to scale {worst:.3e} > 5e-2")
    return (f"max error relative to scale {worst:.2e} over dense, embedding and 12 head maps "
            f"({', '.join(report)}); detections matched {found}/{total}")


def stage_split(bundle, batch, multi_group_predict, greedy_nms_from_iou, tiou) -> None:
    """Host-clock split of one predict with a synchronize after each stage
    (median of 5), plus the IoU kernel and the NMS fixpoint loop alone."""
    model, dev = bundle.model, bundle.device
    names = ["h2d", "backbone", "neck", "head", "decode+iou+nms"]
    rec = {n: [] for n in names}
    iou_in = None
    with torch.inference_mode():
        for _ in range(6):
            marks = [time.perf_counter()]
            vf = batch["voxel_features"].to(dev)
            vc = batch["voxel_coords"].to(dev)
            vv = batch["voxel_valid"].to(dev)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            dense, _ = model.backbone(vf, vc, vv)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            neck = model.neck(dense)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            preds = model.head(neck)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            with Capture(tiou, "iou_matrix") as cap:
                multi_group_predict(preds, bundle.task_anchors, bundle.box_coder, bundle.test_cfg)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            iou_in = cap.calls[0]
            for n, a, b in zip(names, marks[:-1], marks[1:]):
                rec[n].append((b - a) * 1e3)
        iou = tiou.iou_matrix(*iou_in)
        G, N = iou.shape[0], iou.shape[1]
        valid = torch.ones(G, N, dtype=torch.bool, device=dev)
        nms_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            greedy_nms_from_iou(iou, valid, bundle.test_cfg.nms_iou_threshold)
            torch.cuda.synchronize()
            nms_ms.append((time.perf_counter() - t0) * 1e3)
    split = ", ".join(f"{n} {np.median(v[1:]):.2f}" for n, v in rec.items())
    print(f"stage split (ms, median of 5, synchronized per stage): {split}; "
          f"of the last: greedy NMS fixpoint loop {np.median(nms_ms):.2f} ms")


def device_profile(predict, batch, predict_ms: float) -> None:
    """torch.profiler over 3 predicts: the union of the device's kernel and
    copy intervals per predict against the unprofiled predict time (the idle
    share), and the device work that takes the most time. Diagnostics only:
    a profiler that records no device activity is reported, not fatal."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    predict(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            predict(batch)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        print("device profile: the profiler recorded no device activity")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy, cur_s, cur_e = busy + cur_e - cur_s, s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy = (busy + cur_e - cur_s) / 1e3 / 3
    by_name = {}
    for e in dev:
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.end - e.time_range.start, n + 1)
    print(f"device profile (3 predicts): device busy {busy:.2f} ms/predict (union of kernel and "
          f"copy intervals) against the {predict_ms:.2f} ms median predict -> idle share "
          f"{max(0.0, 1 - busy / predict_ms):.3f}; {len(dev) // 3} device activities per predict; top:")
    for name, (tot, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {tot / 1e3 / 3:8.3f} ms/predict  x{n // 3:<4d} {name[:100]}")


if __name__ == "__main__":
    main()
