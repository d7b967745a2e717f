#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (dal3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths at full width with seeded random weights: the
CBGS FPNVoxelNet predict (configs/cbgs_spatial_temporal.py: banded bf16
backbone, RPN, 6-group head, top-k + decode + rotated-IoU NMS) on B=2
lidar-like clouds of 250k points voxelized on the host (mean features,
<= 60000 voxels, bf16), one active-learning selection round through the
selection CLI (pool dataset and loader -> predict every frame -> pool scoring
-> selector -> budgeted greedy k-center -> buffer JSON + subset infos), and
the CBGS trainer through the training CLI (train-mode loader -> train step:
forward, target assignment, loss, banded backward, clip, AdamW -> checkpoint
-> resume -> the selection CLI reads it), the BEVFusion lidar-only
predict on the gather engine (host voxels -> SparseEncoder -> SECOND +
SECONDFPN -> TransFusion head -> decoded boxes), and two active-learning
rounds closed through the CLIs (data preparation and GT database -> seed
selection -> the subset's GT database -> training with GT-AUG and its val
phase -> evaluation -> model-based selection), raw points through the
device voxelizer, the partial-label round (detector and box-quality
estimator trained side by side -> selection that skips the seed set -> the
next round on the picks), BEVFusion lidar-only training (train step with
the Hungarian-matched loss -> the training CLI with resume, warm start and a
converted reference checkpoint), BEVFusion stage 2, camera + lidar (six
camera images -> Swin-T -> LSS FPN -> depth-aware view transform -> camera
BEV map, fused with the lidar map -> the same decoder and head; its train
step, and the training CLI warm-started from the stage-1 run with a
converted Swin), BEVFusion's other heads (map segmentation on the fused map,
trained beside the detector; the CenterPoint head's decode and loss), and
the CBGS model on the gather engine (predict, train step, the synthetic
configs through the CLIs), the CBGS backbone's other engines (brick,
hybrid, dense, and the searchsorted plans), and data parallelism over
``torch.distributed`` ranks (a world of 1 on NCCL, a world of 2 gloo
processes on the one card).
Phases, each fatal on failure:

  1. versions of torch / CUDA / nvcc and the card (nvidia-smi);
  2. builds every kernel from the sources in this checkout (one nvcc per
     source, all started together);
  3. captures the inputs of every kernel launch of one predict and holds each
     launch against the kernel's plain PyTorch version on the same inputs;
     times kernel, plain version and a PyTorch yardstick (index_select +
     matmul for the banded gather-GEMM) at those shapes; host us per call of
     one banded launch, bound once and bound on every call; the rotated IoU
     on the predict's input and on a synthetic [12, 1000, 1000] set, each
     with the share of pairs its cull lets through, its bound for those
     inputs and the all-pairs bound;
  4. the same predict in f32 on a small grid, on the card and on the CPU
     (plain versions): detections equal as sets;
  5. the main path: launch counters set to 0, a warm-up and 10 timed
     predicts, counters read; outputs checked (shapes, finite); the BEV map,
     embedding and head maps held against the same forward with every kernel
     swapped for its plain version; per-stage split and peak memory;
  6. the pairwise L1 / L2 distance kernels against their plain versions at
     the selection's shapes ([4096 | 1 | 600, 512] x [28130, 512] and an
     awkward small one), with times for kernel, plain version, torch.cdist
     and the bound (for L2 the FMA and the 3xTF32 routes, TFLOP/s of f32
     work, the pre-pass's time);
  7. one selection round at full width: a synthetic pool of 32 frames in the
     nuScenes infos schema (250k-point clouds over keyframe + 9 sweep files)
     goes through ``dal3d_tpu_torch.tools.active_select.main`` with a
     FeatureSelector (l2_ref and l2, matrix and streaming) and the
     SpatialTemporalSelector; buffer, subset and pool scores are checked,
     launch counters of all four kernels held to their expected counts, and
     the pool-scoring rate is split into loader / device / fetch;
  8. selection at nuScenes-train size: 28130 seeded embeddings, budget 4800
     on top of a prior round of 600 frames, matrix and streaming k-center for
     both metrics, each selection held to the greedy property under its plain
     distances; the whole-map launch of each metric, L2's beside torch.cdist
     at that shape;
  9. the weight-gradient kernel: every launch of one full-width train step
     against its plain version, with times, bound and an index_select +
     batched-matmul yardstick; three shapes of the path (an L0 subm conv, the
     ds1 strided conv, a deep level) again in f32; the forward kernel as the
     input gradient of a symmetric rulebook, and the index_add_ route of the
     strided conv, against autograd through the plain forward;
 10. one f32 train step on a small grid, on the card (kernels) and on the CPU
     (plain versions): logs, gradients, batch statistics; and on the CPU
     again with the inputs moved by one ulp, to show how far rounding alone
     moves this step's gradient;
 11. the training CLI at full width, B=2, on a labeled synthetic set: an
     epoch through ``dal3d_tpu_torch.tools.train.main``, launch counters held
     to the counts per step, checkpoint, resume, the selection CLI reads the
     result; the loss on a repeated batch falls; step time and its split,
     peak memory, device idle share; the same warm step fed by the loader
     with and without its thread;
 12. BEVFusion lidar-only (TransFusion-L, configs/bevfusion_lidar.py) at
     full width on two 300k-point clouds over +-54 m, voxelized on the host
     at 0.075 m (120000 voxels kept of each): every launch of the fused
     gather-GEMM (21 per predict) held against its plain version and
     bit-equal on a second call, with times for kernel, plain version, a
     PyTorch yardstick, K1's f32 path on the same rulebook, the bounds of
     the FMA and the 3xTF32 routes, TFLOP/s on hits, the (row, tap) pairs
     it multiplies against the hits and against an unsorted walk, and
     the cost of each rulebook's plan (once per rulebook); the row gather
     (1) on the strided view of TransFusion's map, bit-equal to table[idx],
     against advanced indexing on the same view and the old copy +
     index_select, with host us per call; awkward small cases of both
     kernels;
 13. the tiny BEVFusion of the CPU parity tests in f32, on the card and on
     the CPU (plain versions): equal query pixels and labels, boxes and
     scores within 1e-4;
 14. the BEVFusion main path: launch counters set to 0, a warm-up and 10
     timed predicts, counters read (21 and 1 per predict, nothing else);
     outputs checked; BEV maps, heatmap and matched detections held against
     the same forward on plain versions; stage split, peak memory, device
     idle share; 4 frames of a synthetic infos file through the port's
     dataset (the config's test pipeline) and loader into the same step;
 15. two active-learning rounds through the port's CLIs on the production
     config (configs/_cbgs_base.py at full width: its GT-AUG sampler and its
     workflow with a val phase) over a synthetic set of 16 + 4 frames:
     ``create_data synthetic_data_prep`` (infos, lidar files and the GT
     database, 10-sweep names), ``active_select`` (init, then
     ``--force_random``), ``create_data nuscenes_data_prep --suffix``,
     ``train --budget`` (an epoch with GT-AUG from the subset's database,
     then the val phase), ``dist_test --checkpoint --out``, ``active_select
     --checkpoint`` (FeatureSelector, L2 k-center). Launch counters set to 0
     before and read after, held to the counts per predict batch, train step
     and map; the loop's file contracts checked; every IoU call of the
     evaluation held against the same call on the CPU (1e-5) and the
     kitti-style metrics from card IoUs equal to those from CPU IoUs; seconds
     per CLI, the train CLI's iteration and data wait, the eval's frames/s
     split, kitti_eval's seconds with its IoU calls apart; the dist_test
     detections on the trained checkpoint matched against the same path on
     plain versions;
 16. raw points through the device voxelizer (ops/voxelize.py): both
     voxelizers on phase 5's and phase 14's clouds (padded to 300000 points)
     on the card against the same functions on the CPU (integer outputs
     bit-equal, features within 1e-6 of scale), a repeat on the card, device
     ms against the host voxelizer's and the bytes bound; the CBGS and
     BEVFusion predicts fed raw points (launch counts, medians beside the
     host-fed ones, device profiles, maps against plain versions); PPAL and
     CALD rounds through the CLIs (ppal_pred_list, ppal_unc, active_select;
     cald_pred_list plain and --augment, cald_ent, active_select) on phase
     15's set and checkpoint; --torch_init at full width (a det3d .pth of
     seeded weights -> convert_second -> dist_test and an epoch of train,
     the loaded tensors equal to the written ones); the overfit twin
     (tests/test_torch_accuracy.py: 600 steps from raw points, mAP gates,
     detections against the plain versions); the same PPAL / CALD CLIs on
     the twin's trained checkpoint and its 2-frame scene written as a pool,
     on the card and with --cpu: the files compared, at least 4 valid
     detections in each plain list;
 17. the partial-label round through the port's CLIs (configs/cbgs_partial.py
     at full width on phase 15's set, a quarter of it seeded, score threshold
     0): ``train`` with the ActiveTrainer (a train step, then an estimator
     step whose predict runs on the batch's raw points, per iteration), launch
     counters held to those counts; the seed buffer, the checkpoint and
     ``estimator.npz`` checked; the iteration split into train step and
     estimator step (predict + targets, pool, update) and peak memory; the
     capacity report's rows for the production caps; the estimator step from
     the trained checkpoint in f32 with the kernels against the same step on
     plain versions (det_valid and pool indices equal, targets and loss
     within 1e-5), and held whole on the overfit twin's checkpoint and
     scene; ``active_select --checkpoint`` with the EntropySelector and
     ``exclude_buffer`` (no frame of ``partial_01`` picked); a second
     ``train`` with ``active_flag`` set to the new budget key;
 18. BEVFusion lidar-only training (configs/bevfusion_lidar.py at full
     width, f32, B=2, phase 14's clouds with 120 and 200 seeded GT boxes):
     the step's gradient (forward, Hungarian-matched TransFusion loss,
     backward) against the same step with every kernel swapped for its plain
     version and the kernel run's queries and matching (the plain run's own
     matching only a tie away: the same total cost; the gradient within
     twice the gap that rounding
     alone opens, the plain step on features moved by about one ulp, and at
     least 1e-3 of its norm; the stem's too; logs within 1e-4, the same
     matches); every K4 input-gradient launch and every K4-dW launch of one
     step against its plain version over the same plan (dW bit-equal on a
     repeat), with times, bounds and an index_select + bmm yardstick; the
     Hungarian kernel against the plain version (col4row equal) and scipy
     (total cost), the kernel beside the plain version on the card and
     scipy on the host; the IoU cost's and K5's backward device times;
     launch counters set to 0, a warm-up and 5 timed steps, counters read
     (K4 21 + 20, K4-dW 21, K5 1, LSA 1 per step, nothing else); the step
     split into forward, assignment + loss, backward and optimizer, peak
     memory, device idle share; ``train_bevfusion`` on phase 15's set
     (``--budget`` epoch and checkpoint, ``--resume_from``, ``--load_from``
     into a model with another head width, ``convert_bevfusion`` ->
     ``--torch_init`` of seeded mmdet3d-named weights);
 19. BEVFusion stage 2, camera + lidar (configs/bevfusion_cl.py at full
     width: Swin-T on 6 ring cameras at 256 x 704, DepthLSSTransform with 118
     depth bins x 80 channels, ConvFuser, f32, B=2, phase 14's clouds, depth
     images rasterised from them by ReformatCamera): launch counters set to 0,
     a warm-up and 5 timed predicts, counters read (21 and 1 per predict,
     nothing else); the predict split stage by stage (lidar, Swin, FPN, depth
     branch + depthnet, splat, BEV downsample, fuser, decoder, head), peak
     memory, device idle share; bev_pool's device ms against its bytes bound,
     card against the CPU and a repeat; the window attentions' share of the
     Swin with scaled_dot_product_attention on the same bias + mask as a
     yardstick; the camera, fused and neck maps and the matched queries
     against the same forward on plain versions; the camera branch on the
     card against the CPU; the train step's camera gradient against plain
     versions within twice the rounding floor, a warm-up and 3 timed steps
     with their launches (41 / 21 / 1 / 1 per step), split, peak memory and
     idle share; ``train_bevfusion`` with a stage-2 config on a synthetic
     camera set (``--load_from`` phase 18's work dir, ``--swin_init`` of
     seeded Swin-T weights through ``convert_swin``, then ``--resume_from``);
 20. BEVFusion's other heads at full width, B=2: configs/bevfusion_cl.py
     with ``with_map_seg`` (the 180 x 180 fused map, 6 classes) on phase
     19's inputs, its targets from the port's LoadBEVSegmentation on the
     reference's 200 x 200 map grid (so the train step resizes the logits):
     launch counters set to 0, a warm-up and 3 timed predicts (21 K4, 1 K5
     each), seg_logits and the neck map against the same forward on plain
     versions; the train step's gradient against plain versions within
     twice its rounding floor (the seg head's too), every K4 / K4-dW / K5 /
     LSA launch of one step against its plain version, a warm-up and 3
     timed steps (41 / 21 / 1 / 1 each) with the split (the seg loss and its
     share), peak memory and idle share; configs/bevfusion_lidar.py with
     ``head="centerpoint"`` on phase 14's clouds and GT: the forward, its
     decode and center_head_loss with its backward against plain versions
     (heatmaps within 1e-5 of scale, the decoded picks equal but at the
     top-k boundary, the loss within 1e-5, the gradient within twice its
     floor), every K4 / K4-dW launch; ``train_bevfusion`` on
     configs/bevfusion_cl_synthetic.py as written (an epoch, then
     ``--resume_from``; seg losses logged finite and above 0);
 21. the CBGS model on the gather engine at full width, B=2
     (configs/cbgs_spatial_temporal.py with ``impl="gather"``, f32, voxel
     caps (60000, 60000, 30000, 30000)) on phase 3's voxels: every K4 and
     K2 launch of a predict against its plain version, launch counters set
     to 0, a warm-up and 5 timed predicts (21 K4, 1 K2 each), the maps and
     detections against plain versions, stage split, idle share (no cuDNN
     FFT kernel in the predict's profile: an earlier heuristic choice at
     these shapes would serve it from PyTorch's plan cache); a train
     step's gradient against plain versions within twice its floor, every
     K4 (21 + 20 input gradients) and K4-dW (21) launch, a warm-up and 3
     timed steps, split; the capacity report empty, as JAX's; then
     configs/cbgs_synthetic.py, cbgs_entropy_synthetic.py and
     cbgs_partial_synthetic.py as written through ``train``,
     ``active_select`` and ``train`` (ActiveTrainer) on 8 synthetic frames;
 22. the other backbone engines at full width on phase 3's voxels (B=2), one
     seeded state dict for all: ``brick`` (bf16, brick caps (48000, 17000,
     10000, 6000, 6000): the capacity report, every K1 launch of a predict
     against its plain version, a warm-up and 3 timed predicts (42 K1, 1 K2
     each), the maps and every level against the banded engine's where
     neither drops a brick (both at caps no level fills), the maps against
     plain versions, a train step's gradient against plain versions within
     twice its floor (features moved by one bf16 ulp), every K1 / K3 launch
     of a step, a warm-up and 2 timed steps (78 K1, 21 K3 each), split
     (median of 3), peak memory, idle share); ``hybrid`` (f32, voxel caps (60000, 60000, 30000,
     30000): the same with K4 (6 a predict; 6 + 5 dX and 6 K4-dW a step),
     the maps and detections against plain versions); ``dense`` (f32: 2
     timed predicts with the warm-up apart, the on-card oracle: the gather
     engine at caps that hold every level against the dense engine, level
     by level and map by map within 1e-4 of scale, and the production caps'
     dropped sites; one train step at B=2, timed alone, with its peak);
     the searchsorted engine's plans against the grid engine's as sets, the
     gather backbone's 21 convs on them (K4) against the grid plans' map;
     a config importing cbgs_entropy_synthetic.py with ``impl="hybrid"``
     through ``train`` and ``active_select --checkpoint`` on 8 frames;
 23. the gather and hybrid engines in bf16 (configs/cbgs_spatial_temporal.py
     with ``dtype="bfloat16"``, voxel caps (60000, 60000, 30000, 30000)) on
     phase 21's voxels and weights: every bf16 K4 launch of a predict
     against its plain version within one bf16 ulp of scale (2^-7), the
     gather engine's 21 timed beside the f32 K4 on the same plans with
     their plain versions, yardstick and bound; a warm-up and 3 timed
     predicts (21 or 6 bf16 K4, 1 K2, no f32 K4), the maps against phase
     21's f32 maps within 5e-2 of scale, the detections under phase 5's
     loose match against the plain versions' and the f32 model's, stage
     split, idle share; every bf16 K4 / dX / K4-dW launch of a train step
     within one ulp (K4-dW bit-equal on a repeat), the K4-dW launches
     timed, a warm-up and 2 timed steps, split, peak memory, idle share;
 24. data parallel (dal3d_tpu_torch/parallel) on the one card: a world of
     1 on NCCL started by ``init_dist`` from torchrun's variables (phase
     11's production train step bit-equal to the step with no group, an
     epoch of ``train`` whose checkpoint loads with no group); a world of 2
     gloo processes spawned on the card: the step with its backbone in f32
     and 2 frames a rank against the no-group step on 4 (gradient, running
     statistics and AdamW's update within twice their rounding floor, the
     floor the largest gap of the same step with its features moved by one
     f32 ulp, its frames reordered or cuDNN's heuristic convs; K1 78 and K3
     21 launches a rank), the step's time and the gradient reduction's,
     ``active_select`` on phase 7's pool and checkpoint (one sweep a frame)
     with its files byte-equal to one process's, ``dist_test`` on that
     pool at full width with cuDNN's choice pinned (its heuristic among
     deterministic algorithms, in every process) and on the overfit twin (a
     frame a rank), each with its detections equal as sets to one
     process's, an epoch of ``train_bevfusion`` with phase 18's launches a
     step.

Kernel times are device times per call (``cuda_time_ms``: the launches
queued behind a device-side sleep, so that the host's enqueue is not timed);
host microseconds per call are printed apart where they matter (K1, K5, the
gather-GEMM's plans). Prints the whole run's seconds, a ``kernels`` JSON
line, the nvidia-smi line, and as its last line
``{"ok": true, "device": {...}}``. Exits nonzero, printing no result, when no
GPU is present or the port cannot be imported.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import random
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# NVIDIA H100 SXM data sheet (dense): bf16 and TF32 tensor cores, f32 outside
# the tensor cores, HBM3 bandwidth
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# f32 operations per (i, j) pair of the IoU kernel: 2 directions x 4 edges x
# (4 planes x 12 + 18 per-edge clip / cross / accumulate), plus the final 8
IOU_OPS_PER_PAIR = 2 * 4 * (4 * 12 + 18) + 8
# f32 operations per pair of the IoU kernel's cull: the centres' difference
# (2), its squared length (3), the reaches' sum plus margin and its square
# (3), the two distance tests (2), the zero-area test (an add, a compare and
# two logic operations)
IOU_CULL_OPS = 14
K1_PER_PREDICT = 42  # L0: 5 subm x (pad + conv) + ds1 x 2; stages 1-3: 4 x 2 + 2 each
K2_PER_PREDICT = 1
# a train step: the 42 forward launches and one dual gather for every call with
# a symmetric rulebook whose table has a gradient (all but the stem's two, and
# not the four strided convs); one weight gradient per conv whose weight trains
K1_PER_TRAIN_STEP = 42 + 36
K3_PER_TRAIN_STEP = 21
SCATTER_PER_TRAIN_STEP = 4
TRAIN_FRAMES = 8
TIMED_ITERS = 10
B, POINTS, MAX_VOXELS = 2, 250_000, 60000


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def lidar_cloud(rng, n_points=POINTS, extent=51.2) -> np.ndarray:
    """Lidar-like cloud within +-extent m: radial ground rings dense near the
    ego, vertical wall segments and box-shaped object clusters (the
    clustering of a 10-sweep nuScenes frame, as the JAX package's
    tools/microbench.py)."""
    n_ground = int(n_points * 0.55)
    az = rng.uniform(-np.pi, np.pi, n_ground)
    r = 2.0 + (extent - 3.2) * rng.power(2.2, n_ground)
    ground = np.stack([r * np.cos(az), r * np.sin(az),
                       rng.normal(-1.8, 0.05, n_ground) + r * 0.003], 1)
    n_wall = int(n_points * 0.3)
    seg = rng.randint(0, 40, n_wall)
    saz = rng.uniform(-np.pi, np.pi, 40)[seg] + rng.normal(0, 0.02, n_wall)
    sr = rng.uniform(8, extent - 1.2, 40)[seg] + rng.normal(0, 0.3, n_wall)
    wall = np.stack([sr * np.cos(saz), sr * np.sin(saz), rng.uniform(-1.8, 2.8, n_wall)], 1)
    n_obj = n_points - n_ground - n_wall
    oc = rng.uniform(-(extent - 6.2), extent - 6.2, (25, 2))
    oi = rng.randint(0, 25, n_obj)
    obj = np.stack([oc[oi, 0] + rng.uniform(-2.2, 2.2, n_obj),
                    oc[oi, 1] + rng.uniform(-1.0, 1.0, n_obj),
                    rng.uniform(-1.8, 0.2, n_obj)], 1)
    p = np.concatenate([ground, wall, obj], 0).astype(np.float32)
    keep = ((np.abs(p[:, 0]) < extent) & (np.abs(p[:, 1]) < extent) & (p[:, 2] > -5)
            & (p[:, 2] < 3))
    return p[keep]


def cbgs_clouds(seed: int) -> list:
    """Phase 5's B clouds of POINTS lidar-like points, [n, 5] each (x, y, z,
    intensity, time 0), in generation order (ground, walls, objects)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(B):
        p = lidar_cloud(rng)
        out.append(np.concatenate([p, rng.uniform(0, 255, (len(p), 1)).astype(np.float32),
                                   np.zeros((len(p), 1), np.float32)], 1))
    return out


def make_batch(seed: int, cfg):
    """B clouds -> host voxels [B, 60000, ...]. Points stay in generation
    order (ground, walls, objects), as the JAX package's bench.py feeds them,
    so the first 60000 voxels are mostly ground: 41k L0 bricks, inside the
    48000 cap (a shuffled cloud overflows it)."""
    from dal3d_tpu_torch.core.voxel_generator import points_to_voxel_mean as voxelize

    vg = cfg["voxel_generator"]
    vf = np.zeros((B, MAX_VOXELS, 5), np.float32)
    vc = np.zeros((B, MAX_VOXELS, 3), np.int32)
    vv = np.zeros((B, MAX_VOXELS), bool)
    n_vox = []
    for b, pts in enumerate(cbgs_clouds(seed)):
        f, c, _ = voxelize(pts, vg["voxel_size"], vg["range"], vg["max_points_in_voxel"],
                           MAX_VOXELS)
        vf[b, :len(f)], vc[b, :len(f)], vv[b, :len(f)] = f, c, True
        n_vox.append(len(f))
    return vf, vc, vv, n_vox


def cuda_time_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn``: CUDA events around ``iters`` calls
    queued behind a device-side sleep that outlasts their enqueue, so that a
    call whose host work is longer than its device work (a small launch)
    is timed on the device, not on the host (host_us measures the host)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.0, 3.0 * iters * host + 1e-3) * 2e9))  # ~2e9 SM cycles a second
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


def band_bound_ms(table, idx, w) -> float:
    """Least time of one banded launch with these weights: the bytes of
    banded_bound_ms, or 2 * sum_q hits_q * nnz(w[q]) operations (the work
    left when every zero of the weights is skipped), whichever is larger."""
    Bt, Mb, R = table.shape
    es = table.element_size()
    nbytes = Bt * Mb * R * es + idx.numel() * 4 + w.numel() * es + Bt * idx.shape[2] * w.shape[-1] * es
    hits_q = (idx >= 0).sum(dim=(0, 2)).double()
    nnz_q = (w != 0).sum(dim=(1, 2)).double()
    ops = 2.0 * float((hits_q * nnz_q).sum())
    peak = PEAK_BF16 if es == 2 else PEAK_F32
    return max(nbytes / PEAK_BYTES * 1e3, ops / peak * 1e3)


def k1_walk(bd, idx, w, bn: int) -> tuple:
    """(steps the bf16 forward kernel walks, steps of the dense walk) over
    the (row tile, column tile, active tap) triples of one launch: a step is
    one 32-row K-block of one tap; the kernel skips the K-blocks whose
    weights under its bn-wide column tile are all zero (bd.band_block_mask
    is the plain version of its flags)."""
    Bt, Q, M = idx.shape
    bm = 128  # the kernel's row tile
    nmt = -(-M // bm)
    hit = torch.nn.functional.pad(idx >= 0, (0, nmt * bm - M))
    active = hit.view(Bt, Q, nmt, bm).any(-1).sum(dim=(0, 2)).double()  # row tiles per tap
    blocks = bd.band_block_mask(w)  # [Q, nKB, nNB64]
    per = bn // bd.BAND_BLOCK[1]
    nnb = -(-blocks.shape[2] // per)
    blocks = torch.nn.functional.pad(blocks, (0, nnb * per - blocks.shape[2]))
    tile_blocks = blocks.view(Q, blocks.shape[1], nnb, per).any(-1).sum(dim=(1, 2)).double()
    walked = float((active * tile_blocks).sum())
    dense = float(active.sum()) * blocks.shape[1] * nnb
    return walked, dense


def k1_host_us(bd, calls) -> None:
    """Host us per call of one K1 launch of the predict (the first with
    aligned widths): the wrapper, and its C launch alone bound once against
    bound on every call."""
    import ctypes

    table, idx, w = next(c for c in calls if c[0].shape[-1] % 8 == 0 and c[2].shape[-1] % 8 == 0)
    Bt, Mb, R = table.shape
    Q, M = idx.shape[1], idx.shape[2]
    Rout = w.shape[-1]
    flags = torch.empty(Q * -(-R // bd.BAND_BLOCK[0]) * -(-Rout // bd.BAND_BLOCK[1]),
                        dtype=torch.int32, device=table.device)
    out = torch.empty(Bt, M, Rout, dtype=table.dtype, device=table.device)
    args = (table.data_ptr(), idx.data_ptr(), w.data_ptr(), flags.data_ptr(), out.data_ptr(), Bt,
            Mb, R, Q, M, Rout)
    once, per_call = launch_host_us("banded_conv", "banded_conv_bf16",
                                    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6, table.device, args)
    wrapper = host_us(lambda: bd.banded_conv(table, idx, w))
    print(f"banded_conv host us per call (table {tuple(table.shape)}, w {tuple(w.shape)}): wrapper "
          f"{wrapper:.2f}; the C launch alone bound once {once:.2f} vs bound per call with guard "
          f"and stream lookup {per_call:.2f}")


def iou_clips(tiou, rows, cols) -> tuple:
    """(pairs surviving K2's cull, clips these inputs need): of one record
    set against itself the result is symmetric, so a pair and its mirror
    need one clip."""
    keep = ~tiou.iou_cull_plain(rows, cols)
    need = torch.triu(keep).sum() if rows is cols else keep.sum()
    return int(keep.sum()), int(need)


def iou_bound_ms(rows, cols, clips: int) -> tuple:
    """K2's bound for these inputs: the larger of the bytes (records once,
    the output once) and the operations the inputs need (every pair's cull,
    the clips of the surviving pairs) at the f32 peak; and the all-pairs
    operations bound (every pair clipped) beside it. (bound ms, bound by,
    all-pairs ms)."""
    G, N, _ = rows.shape
    M = cols.shape[1]
    nbytes = (rows.numel() + cols.numel() + G * N * M) * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (G * N * M * IOU_CULL_OPS + clips * IOU_OPS_PER_PAIR) / PEAK_F32 * 1e3
    t_all = max(t_bytes, G * N * M * IOU_OPS_PER_PAIR / PEAK_F32 * 1e3)
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")) + (t_all,)


def _clone(a):
    """A copy of a captured argument: a tensor (strides kept), a tuple (the
    gather-GEMM's plan: its tensors copied), or anything else as it is."""
    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, tuple):
        return type(a)(*(_clone(x) for x in a))
    return a


class Capture:
    """Records the inputs of every call of a kernel wrapper (by swapping the
    module attribute the callers look up) for the hold-against-plain and
    timing phases; the calls it wraps still run what the attribute held (the
    kernel wrapper, or a plain version put there)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.calls = []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def spy(*args):
            self.calls.append(tuple(_clone(a) for a in args))
            return self.orig(*args)

        # a wrapper counts on the module attribute it is looked up by
        spy.launches = getattr(self.orig, "launches", 0)
        self.spy = spy
        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        if hasattr(self.orig, "launches"):
            self.orig.launches = self.spy.launches
        setattr(self.module, self.name, self.orig)


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    try:
        from dal3d_tpu_torch.models.builder import build_detector
        from dal3d_tpu_torch.models.heads.mg_head import multi_group_predict
        from dal3d_tpu_torch.ops import _build
        from dal3d_tpu_torch.ops import banded as bd
        from dal3d_tpu_torch.ops import distance as td
        from dal3d_tpu_torch.ops import gather as tg
        from dal3d_tpu_torch.ops import iou_matrix as tiou
        from dal3d_tpu_torch.ops import lsa as tl
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
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, band_bound_ms=0.0, library_ms=0.0,
               t_bytes=0.0, t_ops=0.0, walked=0.0, dense=0.0)
    tile_n = _build.load("banded_conv").banded_conv_tile_n
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
        band = band_bound_ms(table, idx, w)
        bn = tile_n(w.shape[1], w.shape[2])
        walked, dense = k1_walk(bd, idx, w, bn)
        for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms), ("bound_ms", bms),
                     ("band_bound_ms", band), ("t_" + ("bytes" if by == "bytes" else "ops"), bms),
                     ("walked", walked), ("dense", dense)):
            tot[k] += v
        k1_rows.append((n, tuple(table.shape), tuple(idx.shape), tuple(w.shape),
                        int((idx >= 0).sum()), err, tol, ms, pms, lms, bms, by, band, bn,
                        1.0 - walked / max(dense, 1.0)))
    print("banded_conv launches of one predict (kernel vs plain, bf16; tol = 2^-7 x max|plain|; "
          "bound: dense hits x R x Rout; band: hits x nnz(w) per tap; BN: the kernel's column "
          "tile; skipped: share of (tap, 32-row K-block) steps of the active taps skipped as "
          "zero weight blocks):")
    for n, ts, ish, ws, hits, err, tol, ms, pms, lms, bms, by, band, bn, skip in k1_rows:
        print(f"  #{n:2d} table {ts} idx {ish} w {ws} hits {hits}: err {err:.2e} (tol {tol:.2e}) "
              f"kernel {ms:.4f} ms plain {pms:.3f} ms library {lms:.4f} ms bound {bms:.4f} ms ({by}) "
              f"band {band:.4f} ms; BN {bn} skipped {skip:.3f}")
    k1_abs = max(r[5] for r in k1_rows)
    k1_host_us(bd, k1.calls)
    print(f"banded_conv per predict: kernel {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, "
          f"library {tot['library_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms, band bound "
          f"{tot['band_bound_ms']:.3f} ms; steps skipped {1.0 - tot['walked'] / tot['dense']:.3f}; "
          f"max_abs_err {k1_abs:.3e} (max relative to output scale {k1_err:.2e})")

    rows, cols = k2.calls[0]
    if torch.equal(rows, cols):  # the predict passes one record set twice; Capture cloned each
        cols = rows
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
    # both routes: one set against itself (mirrored) and against a copy
    k2_bits = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                  for a, b in ((got, ref), (sgot, sref), (tiou.iou_matrix(rows, rows.clone()), ref)))
    k2_ms = cuda_time_ms(lambda: tiou.iou_matrix(rows, cols), 20)
    k2_plain = cuda_time_ms(lambda: tiou.iou_matrix_plain(rows, cols), 3)
    k2_syn_ms = cuda_time_ms(lambda: tiou.iou_matrix(srec, srec), 20)
    # the floor of the cull and the write: boxes on a 40 m grid, where only a
    # box and itself meet
    grid = np.zeros((12, 1000, 5), np.float32)
    grid[..., 0], grid[..., 1] = np.arange(1000) % 40 * 40.0, np.arange(1000) // 40 * 40.0
    grid[..., 2:4] = bx[..., 2:4]
    grec = tiou._pack_rowdat(torch.from_numpy(grid).to(dev))
    if not torch.equal(tiou.iou_matrix(grec, grec), tiou.iou_matrix_plain(grec, grec)):
        fail("iou_matrix on the 40 m grid differs from its plain version")
    k2_grid_ms = cuda_time_ms(lambda: tiou.iou_matrix(grec, grec), 20)
    k2_keep, k2_clips = iou_clips(tiou, rows, cols)
    k2_syn_keep, k2_syn_clips = iou_clips(tiou, srec, srec)
    k2_bound, k2_by, k2_all = iou_bound_ms(rows, cols, k2_clips)
    k2_syn_bound, k2_syn_by, k2_syn_all = iou_bound_ms(srec, srec, k2_syn_clips)
    k2_share, k2_syn_share = k2_keep / got.numel(), k2_syn_keep / sgot.numel()
    print(f"iou_matrix main-path input {tuple(rows.shape)}: max_abs_err {k2_err:.2e} (tol 1e-05; "
          f"bit-equal on both inputs and both routes: {k2_bits}) kernel {k2_ms:.4f} ms "
          f"plain {k2_plain:.3f} ms; "
          f"pairs surviving the cull {k2_share:.4f} ({k2_clips} clips needed, a pair and its "
          f"mirror once); bound for these inputs {k2_bound:.4f} ms "
          f"({k2_by}), all pairs clipped {k2_all:.4f} ms")
    print(f"iou_matrix synthetic {tuple(srec.shape)}: kernel {k2_syn_ms:.4f} ms; surviving "
          f"{k2_syn_share:.4f}; bound {k2_syn_bound:.4f} ms ({k2_syn_by}), all pairs clipped "
          f"{k2_syn_all:.4f} ms; pairs {checks}; on a 40 m grid of the same boxes (only the "
          f"diagonal survives) {k2_grid_ms:.4f} ms")

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
    device_profile(lambda: predict(batch), "predict", ms_med)

    # 6. distance kernels against their plain versions ---------------------------
    dist = distance_kernels_check(dev)

    # 7. one selection round at full width, through the CLI ------------------------
    with tempfile.TemporaryDirectory(prefix="dal3d_smoke_") as tmp:
        round_launches = selection_round(tmp, dev)

        # 8. selection at nuScenes-train size ---------------------------------------
        train_launches, train_maps = train_size_selection(tmp, dev)

        # 9. the weight-gradient kernel and the banded backward ----------------------
        k3 = weight_gradient_check(cfg, vf, vc, vv, dev)

        # 10. small f32 train step: card (kernels) vs CPU (plain versions) -----------
        print(f"small f32 train step, card vs CPU: {small_f32_train_parity(Config)}")

        # 11. the training CLI at full width -----------------------------------------
        cli, train_paths = training_run(tmp, dev)

        # 12-14. BEVFusion lidar-only predict at full width (K4, K5) ------------------
        counters = (bd.banded_conv, bd.banded_dw, tiou.iou_matrix, td.pairwise_l1,
                    td.pairwise_l2, tg.gather_gemm, tg.gather_rows, tg.gather_dw,
                    tl.linear_sum_assignment, tg.gather_gemm_bf16, tg.gather_dw_bf16)
        gather = bevfusion_main_path(tmp, Config, counters, tg, bd)

        # the overfit twin of phase 16 trains in a process of its own meanwhile
        twin_proc = start_twin(tmp)

        # 15. two AL rounds through the CLIs: data, GT-AUG, train + val, eval -------
        loop_launches, loop = al_loop(tmp, dev, counters)

        # 16. raw points: device voxelizer, predicts, PPAL / CALD, torch_init, overfit
        raw = raw_points_phase(tmp, dev, Config, counters,
                               {"CBGS": ms_med, "BEVFusion": gather["predict_ms"]}, loop,
                               bd, tiou, tg, twin_proc)

        # 17. the partial-label round: ActiveTrainer, exclude_buffer, round 2
        twin = raw.pop("twin")
        partial = partial_phase(tmp, dev, loop, counters, bd, tiou, twin)

        # 18. BEVFusion training: K4 dX, K4-dW, K5's backward, LSA, the step, the CLI
        bftrain = bevfusion_train_phase(tmp, Config, counters, loop, tg, tl)

        # 19. BEVFusion stage 2 (camera + lidar): predict, train step, the CLI
        stage2 = camera_lidar_phase(tmp, Config, counters, tg, tl, bftrain["work_dir"])

        # 20. BEVFusion's map segmentation and CenterPoint heads, the map-seg CLI
        heads = other_heads_phase(tmp, Config, counters, tg, tl)

        # 21. the CBGS backbone on the gather engine: predict, train step, the CLIs
        cbgs_g = cbgs_gather_phase(tmp, Config, counters, tg, tiou)

        # 22. the brick, hybrid, dense and searchsorted engines; a hybrid CLI round
        engines = engines_phase(tmp, Config, counters, tg, bd, tiou)

        # 23. the gather and hybrid engines in bf16: K4 and K4-dW in bf16
        bf16 = bf16_engines_phase(Config, counters, tg, bd, tiou, cbgs_g.pop("f32_ref"))

        # 24. data parallel on the one card: a world of 1 on NCCL, of 2 on gloo
        dp = data_parallel_phase(tmp, train_paths, loop, twin, counters)

    # kernels line, card line, result -------------------------------------------
    kernels = [
        dict(name="banded_conv", route="cuda", source="dal3d_tpu_torch/ops/csrc/banded_conv.cu",
             replaces="dal3d_tpu/ops/banded.py:282", launches=k1_launches,
             max_abs_err=k1_abs, ms=tot["ms"], plain_ms=tot["plain_ms"],
             bound_ms=tot["bound_ms"],
             bound_by="bytes" if tot["t_bytes"] >= tot["t_ops"] else "operations",
             library_ms=tot["library_ms"], band_bound_ms=tot["band_bound_ms"]),
        dict(name="iou_matrix", route="cuda", source="dal3d_tpu_torch/ops/csrc/iou_matrix.cu",
             replaces="dal3d_tpu/ops/pallas_iou.py:133", launches=k2_launches,
             max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain, bound_ms=k2_bound,
             bound_by=k2_by, library_ms=None, design="exact cull of far pairs + compaction",
             all_pairs_bound_ms=k2_all, surviving=k2_share, synthetic_ms=k2_syn_ms,
             synthetic_bound_ms=k2_syn_bound, synthetic_surviving=k2_syn_share,
             grid_ms=k2_grid_ms),
    ]
    kernels[0]["launches_selection_round"] = round_launches["banded_conv"]
    kernels[1]["launches_selection_round"] = round_launches["iou_matrix"]
    kernels[0]["launches_training_run"] = cli["banded_conv"]
    kernels[1]["launches_training_run"] = cli["iou_matrix"]
    kernels.insert(2, dict(
        name="banded_dw", route="cuda", source="dal3d_tpu_torch/ops/csrc/banded_dw.cu",
        replaces="dal3d_tpu/ops/banded.py:341", launches=cli["banded_dw"], **k3))
    for k in kernels:
        k["launches_al_loop"] = loop_launches[k["name"]]
    for name, line, src in (("pairwise_l1", 25, "pairwise_distance"),
                            ("pairwise_l2", 68, "pairwise_l2_tf32")):
        kernels.append(dict(
            name=name, route="cuda", source=f"dal3d_tpu_torch/ops/csrc/{src}.cu",
            row_source="dal3d_tpu_torch/ops/csrc/pairwise_distance.cu",
            replaces=f"dal3d_tpu/ops/pallas_distance.py:{line}",
            launches=round_launches[name], **dist[name],
            launches_selection_round=round_launches[name],
            launches_train_size_selection=train_launches[name],
            launches_al_loop=loop_launches[name], **train_maps[name]))
    for name, line in (("gather_gemm", 123), ("gather_rows", 76)):
        kernels.append(dict(name=name, route="cuda", source="dal3d_tpu_torch/ops/csrc/gather.cu",
                            replaces=f"dal3d_tpu/ops/pallas_gather.py:{line}", **gather[name]))
    kernels.append(dict(
        name="gather_dw", route="cuda", source="dal3d_tpu_torch/ops/csrc/gather.cu",
        replaces="dal3d_tpu/ops/sparse.py:132 (XLA autodiff of gather_gemm: no Pallas kernel)",
        launches=bftrain["launches"]["gather_dw"], **bftrain["gather_dw"]))
    k4b, dwb = bf16["gather"]["k4_times"], bf16["gather"]["dw_times"]
    kernels.append(dict(
        name="gather_gemm_bf16", route="cuda", source="dal3d_tpu_torch/ops/csrc/gather.cu",
        replaces="dal3d_tpu/ops/pallas_gather.py:123",
        launches=bf16["gather"]["launches_predict"]["gather_gemm_bf16"],
        max_abs_err=max(bf16[e]["held"][i]["gather_gemm_bf16"][2] for e in ("gather", "hybrid")
                        for i in (0, 1)),
        max_rel_err=max(bf16[e]["held"][i]["gather_gemm_bf16"][1] for e in ("gather", "hybrid")
                        for i in (0, 1)),
        ms=k4b["ms"], plain_ms=k4b["plain_ms"], bound_ms=k4b["bound_ms"],
        bound_by=k4b["bound_by"], library_ms=k4b["library_ms"], f32_kernel_ms=k4b["f32_ms"],
        hit_pairs=k4b["hits"],
        per="the 21 launches of one bf16 gather predict (phase 23)"))
    kernels.append(dict(
        name="gather_dw_bf16", route="cuda", source="dal3d_tpu_torch/ops/csrc/gather.cu",
        replaces="dal3d_tpu/ops/sparse.py:132 (XLA autodiff of gather_gemm: no Pallas kernel)",
        launches=bf16["gather"]["launches_train"]["gather_dw_bf16"],
        max_abs_err=max(bf16[e]["held"][1]["gather_dw_bf16"][2] for e in ("gather", "hybrid")),
        max_rel_err=max(bf16[e]["held"][1]["gather_dw_bf16"][1] for e in ("gather", "hybrid")),
        ms=dwb["ms"], plain_ms=dwb["plain_ms"], bound_ms=dwb["bound_ms"],
        bound_by=dwb["bound_by"], library_ms=dwb["library_ms"],
        per="the 21 launches of one bf16 gather train step (phase 23)"))
    kernels.append(dict(
        name="linear_sum_assignment", route="cuda", source="dal3d_tpu_torch/ops/csrc/lsa.cu",
        replaces="dal3d_tpu/ops/lsa.py:39 (a lax.while_loop program: no Pallas kernel)",
        launches=bftrain["launches"]["linear_sum_assignment"],
        **bftrain["linear_sum_assignment"]))
    for k in kernels:
        k.setdefault("launches_al_loop", loop_launches[k["name"]])
        k["launches_raw_points"] = raw["launches"][k["name"]]
        k["launches_partial"] = partial["launches"][k["name"]]
        k["launches_bevfusion_train"] = bftrain["launches"][k["name"]]
        k["launches_per_bevfusion_train_step"] = bftrain["launches"][k["name"]] // (
            BF_TRAIN_ITERS + 1)
        k["launches_stage2_predict"] = stage2["launches_predict"][k["name"]]
        k["launches_stage2_train"] = stage2["launches_train"][k["name"]]
        k["launches_map_seg_predict"] = heads["launches_seg_predict"][k["name"]]
        k["launches_map_seg_train"] = heads["launches_seg_train"][k["name"]]
        k["launches_centerpoint"] = heads["launches_centerpoint"][k["name"]]
        k["launches_cbgs_gather_predict"] = cbgs_g["launches_predict"][k["name"]]
        k["launches_cbgs_gather_train"] = cbgs_g["launches_train"][k["name"]]
        for eng in ("brick", "hybrid", "dense"):
            for path in ("predict", "train"):
                k[f"launches_{eng}_{path}"] = engines[eng][f"launches_{path}"][k["name"]]
        k["launches_sorted_engine"] = engines["sorted"]["launches"][k["name"]]
        k["launches_data_parallel"] = dp["launches"][k["name"]]
        for eng in ("gather", "hybrid"):
            for path in ("predict", "train"):
                k[f"launches_bf16_{eng}_{path}"] = bf16[eng][f"launches_{path}"][k["name"]]
    print(f"chip_smoke: whole run {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def small_f32_parity(Config, build_detector, make_predict_step) -> str:
    """f32 predict on a 12.8 m grid (sparse shape (41, 64, 64)), production
    widths: the card's kernels vs the CPU's plain versions must give the same
    detections (sets) and embeddings within 1e-4."""
    from dal3d_tpu_torch.core.voxel_generator import points_to_voxel_mean as voxelize

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
    f, c, _ = voxelize(pts, cfg["voxel_generator"]["voxel_size"],
                       cfg["voxel_generator"]["range"], 10, 1500)
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
    from dal3d_tpu_torch.runtime.steps import autotuned_convs, model_inputs

    def forward():
        with torch.inference_mode(), autotuned_convs():
            return bundle.model(**model_inputs(batch, bundle.device))

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
    from dal3d_tpu_torch.runtime.steps import autotuned_convs

    model, dev = bundle.model, bundle.device
    names = ["h2d", "backbone", "neck", "head", "decode+iou+nms"]
    rec = {n: [] for n in names}
    iou_in = None
    with torch.inference_mode(), autotuned_convs():
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


def device_profile(run, what: str, run_ms: float) -> dict:
    """torch.profiler over 3 calls of ``run`` (a predict, a train step): the
    union of the device's kernel and copy intervals per call against the
    unprofiled time of one call (the idle share), and the device work that
    takes the most time. Returns {activity name: (ms per call, count per
    call)}. Diagnostics only: a profiler that records no device activity is
    reported, not fatal."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            run()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        print(f"device profile ({what}): the profiler recorded no device activity")
        return {}
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
    print(f"device profile (3 x {what}): device busy {busy:.2f} ms/{what} (union of kernel and "
          f"copy intervals) against the {run_ms:.2f} ms median {what} -> idle share "
          f"{max(0.0, 1 - busy / run_ms):.3f}; {len(dev) // 3} device activities per {what}; top:")
    for name, (tot, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"  {tot / 1e3 / 3:8.3f} ms/{what}  x{n // 3:<4d} {name[:100]}")
    return {name: (tot / 1e3 / 3, n / 3) for name, (tot, n) in by_name.items()}

# ---------------------------------------------------------------------------
# selection: distance kernels, one round through the CLI, train-size k-center
# ---------------------------------------------------------------------------
N_TRAIN, EMB_C = 28130, 512  # nuScenes train frames, pooled neck embedding width
POOL_FRAMES, POOL_LOGS, POOL_BUDGET = 32, 4, 12
L1_OPS, L2_OPS = 3, 2  # f32 operations per element step: subtract, abs, add / one FMA


def embeddings(rng, n: int, scenes: int) -> np.ndarray:
    """Seeded [n, 512] f32 shaped like pooled neck embeddings: non-negative
    (after ReLU and pooling), frames of one scene close to each other."""
    centers = rng.randn(scenes, EMB_C).astype(np.float32)
    scene = np.sort(rng.randint(0, scenes, n))
    return np.maximum(centers[scene] + 0.35 * rng.randn(n, EMB_C).astype(np.float32), 0.0)


def distance_bound_ms(N: int, M: int, C: int, metric: str) -> tuple:
    """(bound ms, bound by, FMA route ms, 3xTF32 route ms or None). The
    operations' time is the lesser of the routes the card has for the work:
    L1's 3 f32 operations per element step on the FMA units (it has no
    tensor-core form); L2's product on the FMA units (one FMA, 2 operations
    per step) or on the tensor cores as three TF32 products (2 operations
    each at the TF32 peak). The bound is the larger of that and the bytes
    (inputs once, the output once)."""
    t_bytes = (N * C + M * C + N * M) * 4 / PEAK_BYTES * 1e3
    steps = float(N) * M * C
    t_fma = steps * (L1_OPS if metric == "pairwise_l1" else L2_OPS) / PEAK_F32 * 1e3
    t_tc = None if metric == "pairwise_l1" else 3 * 2 * steps / PEAK_TF32 * 1e3
    t_ops = t_fma if t_tc is None else min(t_fma, t_tc)
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")) + (t_fma, t_tc)


def distance_error(metric: str, fn, plain, x, y, tag: str) -> tuple:
    """One kernel call against its plain version on the same inputs, fatal
    beyond the tolerance. Returns (max abs error, its tolerance): of the
    distances for L1, of the squared distances for L2."""
    got = fn(x, y)
    torch.cuda.synchronize()
    ref = plain(x, y)
    if metric == "pairwise_l1":
        err, tol = float((got - ref).abs().max()), 1e-5 * float(ref.abs().max())
        ok = err <= tol
    else:
        scale = (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
        got2, ref2 = fn(x, y, squared=True), plain(x, y, squared=True)
        far = ref > 0.1 * scale.sqrt()
        rel = float(((got - ref).abs() / ref.clamp(min=1e-30))[far].max()) if bool(far.any()) else 0.0
        ok = (float(((got2 - ref2).abs() / scale).max()) <= 2e-6 and rel <= 1e-4
              and bool(torch.isfinite(got).all()))
        err, tol = float((got2 - ref2).abs().max()), 2e-6 * float(scale.max())
    if not ok:
        fail(f"{metric} {tag} {tuple(x.shape)} x {tuple(y.shape)}: error {err:.3e} (tol {tol:.3e})")
    return err, tol


def distance_kernels_check(dev) -> dict:
    """K6 / K7 against their plain versions at the selection's shapes. L1:
    C non-negative terms summed in another order, |err| <= 1e-5 x max|plain|.
    L2: squared distances within 2e-6 of the scale |x|^2 + |y|^2 (the Gram
    expression cancels), and distances within 1e-4 relative wherever the
    plain distance exceeds 0.1 x sqrt(scale), i.e. away from the diagonal
    (an error of 2e-6 x scale in d^2 is 1e-4 relative in d at that distance).
    torch.cdist (TF32 off) is the library yardstick. Returns the kernels-line
    numbers of each metric at the [4096, 512] x [28130, 512] band."""
    from dal3d_tpu_torch.ops import distance as td

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(6)
    pool = torch.from_numpy(embeddings(rng, N_TRAIN, 850)).to(dev)
    small = torch.from_numpy(np.abs(rng.randn(1031, 16)).astype(np.float32)).to(dev)
    shapes = [("band", pool[:4096], pool), ("row", pool[777:778], pool),
              ("init", pool[::46][:600].contiguous(), pool), ("awkward", small[:257], small)]
    out = {}
    print("pairwise distance kernels vs plain (l1: |err| <= 1e-5 x max|plain|; l2: squared "
          "distances within 2e-6 x (|x|^2+|y|^2), err and tol printed at the largest scale, "
          "distances 1e-4 relative away from the diagonal; l2 with more than 8 rows: 3xTF32 "
          "on the tensor cores, its time including the pre-pass):")
    for metric, fn, plain, p in (("pairwise_l1", td.pairwise_l1, td.pairwise_l1_plain, 1.0),
                                 ("pairwise_l2", td.pairwise_l2, td.pairwise_l2_plain, 2.0)):
        worst = 0.0
        for tag, x, y in shapes:
            N, M, C = x.shape[0], y.shape[0], x.shape[1]
            err, tol = distance_error(metric, fn, plain, x, y, tag)
            iters = 3 if N >= 600 else 50
            ms = cuda_time_ms(lambda: fn(x, y), iters)
            pms = cuda_time_ms(lambda: plain(x, y), 1)
            lms = cuda_time_ms(lambda: torch.cdist(x, y, p=p), 1 if N >= 600 else 5)
            bms, by, t_fma, t_tc = distance_bound_ms(N, M, C, metric)
            worst = max(worst, err)
            line = (f"  {metric} {tag:8s} [{N},{C}]x[{M},{C}]: err {err:.2e} (tol {tol:.2e}) kernel "
                    f"{ms:.4f} ms plain {pms:.3f} ms cdist {lms:.4f} ms bound {bms:.4f} ms ({by}; "
                    f"FMA route {t_fma:.4f}" + ("" if t_tc is None else f", 3xTF32 route {t_tc:.4f}")
                    + f"); {2.0 * N * M * C / ms / 1e9:.1f} TFLOP/s of f32 work")
            extra = {}
            if metric == "pairwise_l2" and N > td._ROW_MAX_N:
                cp = -(-C // td._K_TILE) * td._K_TILE
                split_ms = (cuda_time_ms(lambda: td.l2_split(x, cp), 20)
                            + cuda_time_ms(lambda: td.l2_split(y, cp), 20))
                line += f"; pre-pass of x and y {split_ms:.4f} ms of it"
                extra = dict(split_ms=split_ms, fma_bound_ms=t_fma, tf32x3_bound_ms=t_tc,
                             tflops_f32=2.0 * N * M * C / ms / 1e9)
            print(line)
            if tag == "band":
                out[metric] = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
                                   library_ms=lms, shape=f"[{N},{C}]x[{M},{C}]", **extra)
            elif tag == "row":  # the streaming launch, once per pick
                row = dict(row_ms=ms, row_bound_ms=bms, row_library_ms=lms)
        out[metric].update(row, max_abs_err=worst)
    out["pairwise_l2"]["design"] = "3xTF32 wgmma (TMA ring, mbarriers) above 8 rows"
    return out


def write_pool(root: str, n_frames: int, n_logs: int, seed: int) -> tuple:
    """A synthetic pool in the nuScenes infos schema: per frame a lidar-like
    cloud of ~250k points split over the keyframe file and 9 sweep files
    (sweep k holds every 10th point, as ten sparser scans of one scene),
    several logfiles, ego poses along a line, 0-60 boxes. Returns (infos
    path, logs json path)."""
    rng = np.random.RandomState(seed)
    lidar_dir = os.path.join(root, "samples", "LIDAR_TOP")
    sweep_dir = os.path.join(root, "sweeps", "LIDAR_TOP")
    os.makedirs(lidar_dir)
    os.makedirs(sweep_dir)
    logs = [f"n008-2018-0{i + 1}-01-00-00-00-0400" for i in range(n_logs)]
    names = ["car", "truck", "bus", "pedestrian", "barrier", "traffic_cone"]
    infos = []
    for fi in range(n_frames):
        p = lidar_cloud(rng)
        pts = np.concatenate([p, rng.uniform(0, 255, (len(p), 1)).astype(np.float32),
                              np.zeros((len(p), 1), np.float32)], 1)
        token = f"smoketoken{fi:06d}"
        paths = []
        for k in range(10):
            path = os.path.join(lidar_dir if k == 0 else sweep_dir, f"{token}_{k}.pcd.bin")
            pts[k::10].tofile(path)
            paths.append(path)
        n_box = int(rng.randint(0, 61))
        boxes = np.zeros((n_box, 9), np.float32)
        boxes[:, :2] = rng.uniform(-45, 45, (n_box, 2))
        boxes[:, 3:6] = [1.97, 4.63, 1.74]
        car_from_global = np.eye(4)
        car_from_global[:3, 3] = [-fi * 10.0, -(fi % n_logs) * 100.0, 0.0]
        log = logs[fi * n_logs // n_frames]
        infos.append({
            "lidar_path": paths[0],
            "cam_front_path": os.path.join(root, "samples", "CAM_FRONT",
                                           f"{log}__CAM_FRONT__{1531883530412470 + fi}.jpg"),
            "token": token,
            "sweeps": [{"lidar_path": paths[k], "sample_data_token": f"{token}_sweep{k}",
                        "transform_matrix": np.eye(4), "time_lag": 0.05 * k}
                       for k in range(1, 10)],
            "ref_from_car": np.eye(4), "car_from_global": car_from_global,
            "timestamp": 1531883530.412470 + fi * 0.5,
            "gt_boxes": boxes, "gt_boxes_velocity": np.zeros((n_box, 3), np.float32),
            "gt_names": np.asarray([names[i % len(names)] for i in range(n_box)]),
            "gt_boxes_token": np.asarray([f"{token}_gt{b}" for b in range(n_box)]),
        })
    info_path = os.path.join(root, "infos_train_10sweeps_withvelo.pkl")
    with open(info_path, "wb") as f:
        pickle.dump(infos, f)
    logs_path = os.path.join(root, "log.json")
    with open(logs_path, "w") as f:
        json.dump([{"logfile": lf, "location": "singapore-onenorth"} for lf in logs], f)
    return info_path, logs_path


def write_config(path: str, selector: dict, extra: str = "") -> None:
    """An experiment config on the production base, with this selector and
    any further lines."""
    with open(path, "w") as f:
        f.write(f"import sys\nsys.path.insert(0, {os.path.join(ROOT, 'configs')!r})\n"
                f"from _cbgs_base import *  # noqa: F401,F403\nselector = {selector!r}\n{extra}")


def check_round(tag: str, buffer_file: str, info_path: str, infos, budget_key: str,
                prior=()) -> list:
    """The file contract of one round: the buffer has the cumulative-budget
    key, no duplicates, the prior round carried over, total cost within the
    budget, and the subset pkl holds exactly the chosen infos."""
    with open(buffer_file) as f:
        buffer = json.load(f)
    if budget_key not in buffer:
        fail(f"{tag}: buffer has no key {budget_key}: {list(buffer)}")
    chosen = buffer[budget_key]
    cost = sum(0.12 + 0.04 * len(infos[i]["gt_names"]) for i in chosen)
    new = [i for i in chosen if i not in set(prior)]
    if (len(chosen) != len(set(chosen)) or not new or not set(prior) <= set(chosen)
            or cost > float(budget_key) + 1e-6):
        fail(f"{tag}: bad selection: {len(chosen)} frames, {len(set(chosen))} distinct, "
             f"{len(new)} new, cost {cost:.2f} against budget {budget_key}")
    stem, ext = os.path.splitext(info_path)
    with open(f"{stem}_{budget_key}{ext}", "rb") as f:
        subset = pickle.load(f)
    if [s["token"] for s in subset] != [infos[i]["token"] for i in chosen]:
        fail(f"{tag}: subset infos do not match the buffer")
    return new


def selection_round(tmp: str, dev) -> dict:
    """Phase 7. Returns the launches of each kernel over the CLI runs."""
    from dal3d_tpu_torch.models.builder import build_detector
    from dal3d_tpu_torch.ops import banded as bd
    from dal3d_tpu_torch.ops import distance as td
    from dal3d_tpu_torch.ops import iou_matrix as tiou
    from dal3d_tpu_torch.ops import sparse_brick as spb
    from dal3d_tpu_torch.runtime.checkpoint import save_checkpoint
    from dal3d_tpu_torch.selectors import build_selector
    from dal3d_tpu_torch.selectors.base_selector import _finish_fetch, _start_fetch
    from dal3d_tpu_torch.tools import active_select
    from dal3d_tpu_torch.utils.config import Config

    t0 = time.perf_counter()
    info_path, logs_path = write_pool(os.path.join(tmp, "nusc"), POOL_FRAMES, POOL_LOGS, seed=10)
    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    base = Config.fromfile(os.path.join(ROOT, "configs", "cbgs_feature.py"))
    work_dir = os.path.join(tmp, "work")
    model = build_detector(base, seed=0).model
    save_checkpoint(work_dir, model, epoch=1)
    backbone = model.backbone  # its static knobs, for the capacity report
    del model
    print(f"pool: {POOL_FRAMES} frames x 10 lidar files in {POOL_LOGS} logs, checkpoint saved "
          f"({time.perf_counter() - t0:.1f} s)")

    buffer_file = os.path.join(tmp, "buffer.json")
    pred_file = os.path.join(tmp, "pool_pred.npz")
    common = dict(budget=POOL_BUDGET, buffer_file=buffer_file, infos_origin=info_path)
    feature = dict(type="FeatureSelector", pred_store_file=pred_file, **common)
    runs = [("feature l2_ref matrix", dict(feature, distance_type="l2_ref", streaming=False)),
            ("feature l2_ref streaming", dict(feature, distance_type="l2_ref", streaming=True)),
            ("feature l2 matrix", dict(feature, distance_type="l2", streaming=False)),
            ("feature l2 streaming", dict(feature, distance_type="l2", streaming=True)),
            ("spatial_temporal", dict(type="SpatialTemporalSelector", k=8, logs_file=logs_path,
                                      normalize="exp", lambda_t=1, aggregate="sum",
                                      distance_store_file=os.path.join(tmp, "dijkstra.npy"),
                                      **common))]
    wrappers = {"banded_conv": bd.banded_conv, "iou_matrix": tiou.iou_matrix,
                "pairwise_l1": td.pairwise_l1, "pairwise_l2": td.pairwise_l2}
    for w in wrappers.values():
        w.launches = 0
    picks, seconds = {}, {}
    cfg_path = os.path.join(tmp, "round.py")
    for tag, selector in runs:
        write_config(cfg_path, selector)
        with open(buffer_file, "w") as f:
            json.dump({"0": []}, f)
        t0 = time.perf_counter()
        active_select.main([cfg_path, "--checkpoint", work_dir, "--seed", "3407"])
        torch.cuda.synchronize()
        seconds[tag] = time.perf_counter() - t0
        picks[tag] = check_round(tag, buffer_file, info_path, infos, str(POOL_BUDGET))
    launches = {k: w.launches for k, w in wrappers.items()}
    n_batches = (POOL_FRAMES + B - 1) // B
    # the first run scores the pool (the others find its cache); a matrix run
    # launches one distance kernel (feature_map), a streaming run from an
    # empty buffer one per greedy step: each kept pick after the first and
    # the one that crosses the budget
    expect = {"banded_conv": K1_PER_PREDICT * n_batches, "iou_matrix": K2_PER_PREDICT * n_batches,
              "pairwise_l1": 1 + len(picks["feature l2_ref streaming"]),
              "pairwise_l2": 1 + len(picks["feature l2 streaming"])}
    if launches != expect:
        fail(f"selection round launched {launches}, expected {expect}")
    for metric in ("l2_ref", "l2"):
        a, b = picks[f"feature {metric} matrix"], picks[f"feature {metric} streaming"]
        if a != b:
            fail(f"streaming and matrix selections differ for {metric}: {a} vs {b}")
    print(f"selection round through the CLI (budget {POOL_BUDGET}): "
          + "; ".join(f"{t} {len(p)} picks in {seconds[t]:.2f} s" for t, p in picks.items()))
    print(f"  launches over the 5 runs: {launches} (as expected); streaming == matrix for both "
          f"metrics (l2_ref {picks['feature l2_ref matrix']}, l2 {picks['feature l2 matrix']})")

    # the pool scores against a direct predict of the same batches, and the split
    scores = dict(np.load(pred_file))
    pe = torch.from_numpy(scores["embedding"]).to(dev)
    for metric, fn, plain in (("pairwise_l1", td.pairwise_l1, td.pairwise_l1_plain),
                              ("pairwise_l2", td.pairwise_l2, td.pairwise_l2_plain)):
        for tag, x in (("pool map", pe), ("pool row", pe[5:6])):
            err, tol = distance_error(metric, fn, plain, x, pe, tag)
            print(f"  {metric} {tag} {tuple(x.shape)} x {tuple(pe.shape)} on the pool's embeddings: "
                  f"err {err:.2e} (tol {tol:.2e})")
    write_config(cfg_path, runs[0][1])
    cfg = Config.fromfile(cfg_path)
    score_fn, loader = active_select.build_pool_scoring(cfg, dict(cfg["selector"]), dev, work_dir)
    keys = ("embedding", "score_entropy", "scores", "label_preds", "det_valid")
    host_s = []
    for i in range(4):  # file reads + sweep transforms + host voxelization, one thread
        t0 = time.perf_counter()
        loader.dataset[i]
        host_s.append(time.perf_counter() - t0)
    np.random.seed(3407)  # the CLI's seed: the loader draws the same sweep order
    direct = {k: [] for k in keys}
    dev_s, fetch_s, dropped, n_vox = [], [], 0, 0
    for batch in loader:
        t_a = time.perf_counter()
        out = score_fn(batch)
        torch.cuda.synchronize()
        t_b = time.perf_counter()
        _finish_fetch(_start_fetch(out, keys), direct)
        dev_s.append(t_b - t_a)
        fetch_s.append(time.perf_counter() - t_b)
        vc = torch.from_numpy(batch["voxel_coords"]).to(dev)
        vv = torch.from_numpy(batch["voxel_valid"]).to(dev)
        _, row = spb.pack_plan_arrays(vc, vv, backbone.sparse_shape, backbone.widths[0],
                                      backbone.caps[0])
        dropped += int((vv & (row < 0)).sum())
        n_vox += int(vv.sum())
    direct = {k: np.concatenate(v)[:POOL_FRAMES] for k, v in direct.items()}
    for k in ("embedding", "score_entropy"):
        if scores[k].shape != direct[k].shape or not np.all(np.isfinite(scores[k])):
            fail(f"pool scores: {k} has shape {scores[k].shape} or is not finite")
        scale = max(float(np.abs(direct[k]).max()), 1e-30)
        err = float(np.abs(scores[k] - direct[k]).max()) / scale
        if err > 1e-3:
            fail(f"pool scores: {k} differs from a direct predict by {err:.2e} of its scale")
    if scores["embedding"].shape != (POOL_FRAMES, EMB_C):
        fail(f"pool scores: embedding shape {scores['embedding'].shape}")
    # the pipelined pass as the selector runs it (no cache)
    selector = build_selector(dict(runs[0][1], pred_store_file=None),
                              default_args=dict(detector=score_fn, dataloader=loader, device=dev))
    np.random.seed(3407)
    t0 = time.perf_counter()
    again = selector.run_pool_scoring()
    t_pool = time.perf_counter() - t0
    drift = float(np.abs(again["embedding"] - scores["embedding"]).max()
                  / np.abs(scores["embedding"]).max())
    if again["embedding"].shape != scores["embedding"].shape or drift > 1e-3:
        fail(f"a second pool scoring pass differs from the first by {drift:.2e} of scale")
    print(f"pool scoring: {POOL_FRAMES} frames in {t_pool:.2f} s -> {POOL_FRAMES / t_pool:.2f} "
          f"frames/s (pipeline depth 2, one loader thread); split: host prep (file reads, sweep "
          f"transforms, numpy voxelization) {np.median(host_s) * 1e3:.1f} ms per frame on one "
          f"thread, device predict {np.median(dev_s) * 1e3:.1f} ms per batch of {B} "
          f"(synchronized), fetch {np.median(fetch_s) * 1e3:.2f} ms per batch; scores equal to a direct predict of the same "
          f"batches (1e-3 of scale); {n_vox // POOL_FRAMES} voxels per frame, {dropped} of "
          f"{n_vox} voxels dropped at the L0 brick cap")
    return launches


def greedy_property(feats, new, prior, costs, remaining, plain, rel_tol: float) -> tuple:
    """Holds a selection to the greedy farthest-point property under the
    plain distances: every pick after the first has, at its step, an fps
    value within ``rel_tol`` x the step's maximum of that maximum; no pick is
    repeated or in the prior set; the cost stays within the budget. Returns
    (worst shortfall relative to the step's maximum, total cost)."""
    dev = feats.device
    if len(set(new)) != len(new) or set(new) & set(prior):
        fail("selection repeats a frame or re-picks a labeled one")
    idx = torch.as_tensor(new, device=dev)
    fps = torch.full((feats.shape[0],), float("inf"), device=dev)
    for i in range(0, len(prior), 64):
        p = torch.as_tensor(prior[i:i + 64], device=dev)
        fps = torch.minimum(fps, plain(feats[p], feats).min(0).values)
    fps[torch.as_tensor(prior, device=dev, dtype=torch.long)] = float("-inf")
    short = torch.zeros(len(new), device=dev)
    for t, i in enumerate(new):
        if t > 0 or prior:
            best = fps.max()
            short[t] = (best - fps[i]) / best
        fps = torch.minimum(fps, plain(feats[i:i + 1], feats)[0])
        fps[i] = float("-inf")
    worst = float(short.max())
    cost = float(np.float32(costs[new].astype(np.float32).sum()))
    if worst > rel_tol or cost > remaining + 1e-3:
        fail(f"greedy property: worst shortfall {worst:.2e} (tol {rel_tol:.0e}), cost {cost:.2f} "
             f"against {remaining:.2f}")
    return worst, cost


def kcenter_loop_ms(feats, costs, prior, remaining, wrapper) -> tuple:
    """The greedy loop alone at train size, inputs already on the card:
    (ms per pick over the materialized map, ms per pick streaming, picks)."""
    from dal3d_tpu_torch.ops.kcenter import kcenter_features, kcenter_matrix

    dev, n = feats.device, feats.shape[0]
    already = torch.zeros(n, dtype=torch.bool, device=dev)
    already[torch.as_tensor(prior, device=dev)] = True
    init = wrapper(feats[already], feats).min(0).values
    first = int(torch.where(already, float("-inf"), init).argmax())
    c32 = torch.from_numpy(costs.astype(np.float32)).to(dev)
    args = (c32, np.float32(remaining), init, first, already, n - len(prior))
    dist = wrapper(feats, feats)
    out = []
    for run in (lambda: kcenter_matrix(dist, *args),
                lambda: kcenter_features(feats, *args,
                                         metric="l1" if wrapper.__name__ == "pairwise_l1" else "l2")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, count, _ = run()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) / count * 1e3)
    return out[0], out[1], count


def train_size_selection(tmp: str, dev) -> dict:
    """Phase 8 (returns the launches of each kernel over the selector runs,
    and its whole-map launch time). N = 28130 seeded embeddings and frame costs (0.12 + 0.04 x
    boxes, boxes 0-60), budget 4800 on top of a prior round of 600 frames,
    through FeatureSelector: the materialized map (kcenter_on_map) and the
    streaming loop (kcenter_on_features), for l2_ref (L1) and l2."""
    from dal3d_tpu_torch.ops import distance as td
    from dal3d_tpu_torch.selectors import build_selector

    rng = np.random.RandomState(8)
    emb = embeddings(rng, N_TRAIN, 850)
    boxes = rng.randint(0, 61, N_TRAIN)
    infos = [{"token": f"t{i}", "gt_names": ["car"] * int(b)} for i, b in enumerate(boxes)]
    info_path = os.path.join(tmp, "train_infos.pkl")
    with open(info_path, "wb") as f:
        pickle.dump(infos, f)
    pred_file = os.path.join(tmp, "train_pred.npz")
    np.savez(pred_file, embedding=emb, score_entropy=rng.rand(N_TRAIN).astype(np.float32),
             scores=np.zeros((N_TRAIN, 1), np.float32), label_preds=np.zeros((N_TRAIN, 1), np.int64),
             det_valid=np.zeros((N_TRAIN, 1), bool))
    costs = 0.12 + 0.04 * boxes
    prior = sorted(rng.choice(N_TRAIN, 600, replace=False).tolist())
    prior_key = str(int(np.ceil(costs[prior].sum())))
    budget = 4800
    remaining = float(int(prior_key) + budget) - float(costs[prior].sum())
    buffer_file = os.path.join(tmp, "train_buffer.json")
    feats = torch.from_numpy(emb).to(dev)
    launches, maps = {}, {}
    print(f"selection at nuScenes-train size: N = {N_TRAIN}, C = {EMB_C}, prior round of 600 "
          f"frames (key {prior_key}), budget {budget}, remaining {remaining:.1f}")
    for metric, wrapper, plain in (("l2_ref", td.pairwise_l1, td.pairwise_l1_plain),
                                   ("l2", td.pairwise_l2, td.pairwise_l2_plain)):
        mat_ms = cuda_time_ms(lambda: wrapper(feats, feats), 2)
        bms, by, t_fma, t_tc = distance_bound_ms(N_TRAIN, N_TRAIN, EMB_C, wrapper.__name__)
        # cdist (TF32 off) at the map's shape, for L2 only: cdist p=1 is ~40x slower
        lib_ms = cuda_time_ms(lambda: torch.cdist(feats, feats), 1) if metric == "l2" else None
        # the whole map against the plain version, 4096 rows of it at a time
        full = wrapper(feats, feats)
        full2 = wrapper(feats, feats, squared=True) if metric == "l2" else None
        full_err = 0.0
        for i in range(0, N_TRAIN, 4096):
            x = feats[i:i + 4096]
            if metric == "l2_ref":
                ref = plain(x, feats)
                err, tol = float((full[i:i + 4096] - ref).abs().max()), 1e-5 * float(ref.abs().max())
            else:
                scale = (x * x).sum(1)[:, None] + (feats * feats).sum(1)[None, :]
                err = float(((full2[i:i + 4096] - plain(x, feats, squared=True)).abs() / scale).max())
                tol = 2e-6
            if not err <= tol:
                fail(f"{wrapper.__name__} full map, rows {i}..: error {err:.3e} > {tol:.3e}")
            full_err = max(full_err, err / tol)
        del full, full2
        wrapper.launches = 0
        for streaming in (False, True):
            with open(buffer_file, "w") as f:
                json.dump({"0": [], prior_key: prior}, f)
            random.seed(1)
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated() / 1e9  # by earlier phases and feats
            before = wrapper.launches
            selector = build_selector(dict(
                type="FeatureSelector", distance_type=metric, streaming=streaming,
                pred_store_file=pred_file, budget=budget, buffer_file=buffer_file,
                infos_origin=info_path, device=dev))
            t0 = time.perf_counter()
            selector.select_samples()
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 1e9
            selector.dump_file()
            tag = f"train-size {metric} {'streaming' if streaming else 'matrix'}"
            new = check_round(tag, buffer_file, info_path, infos, selector.current_budget, prior)
            used = wrapper.launches - before
            # matrix: feature_map alone; streaming: the prior round's init_fps
            # and one row per greedy step (the kept picks after the first,
            # which init_fps gives, and the pick that crosses the budget)
            want = 1 if not streaming else 1 + len(new)
            if used != want:
                fail(f"{tag}: {used} launches of {wrapper.__name__}, expected {want}")
            worst, cost = greedy_property(feats, new, prior, costs, remaining, plain, 1e-4)
            print(f"  {tag}: {len(new)} picks, select_samples {sec:.2f} s ({sec / len(new) * 1e3:.3f} "
                  f"ms per pick, with loading the score cache"
                  f"{'' if streaming else ' and the map through host memory'}), cost {cost:.1f} <= "
                  f"{remaining:.1f}, greedy shortfall {worst:.1e} of the step maximum (tol 1e-04), "
                  f"{used} launches, peak memory {peak - held:.2f} GB above the {held:.2f} GB held")
        launches[wrapper.__name__] = wrapper.launches  # of the two selector runs
        loop = kcenter_loop_ms(feats, costs, prior, remaining, wrapper)
        print(f"  {wrapper.__name__} [{N_TRAIN},{EMB_C}]x[{N_TRAIN},{EMB_C}] matrix launch: "
              f"{mat_ms:.2f} ms ({2.0 * N_TRAIN * N_TRAIN * EMB_C / mat_ms / 1e9:.1f} TFLOP/s of "
              f"f32 work), bound {bms:.2f} ms ({by}; FMA route {t_fma:.2f}"
              + ("" if t_tc is None else f", 3xTF32 route {t_tc:.2f}") + ")"
              + ("" if lib_ms is None else f", cdist {lib_ms:.2f} ms") +
              f"; whole map within {full_err:.2f} of its "
              f"tolerance of the plain version; k-center loop alone: matrix {loop[0]:.3f} ms per "
              f"pick, streaming {loop[1]:.3f} ms per pick ({loop[2]} picks)")
        maps[wrapper.__name__] = dict(map_ms=mat_ms, map_bound_ms=bms, map_library_ms=lib_ms)
    return launches, maps


# ---------------------------------------------------------------------------
# training: the weight-gradient kernel, a small f32 step, the training CLI
# ---------------------------------------------------------------------------


def random_gt(cfg, rng, batch: int, per_task: int, extent: float, max_gt: int = 128):
    """Padded per-task GT boxes near each class's anchor size and height:
    lists per task of [B, max_gt, 9] f32 and [B, max_gt] int32 (task-local
    1-based class ids, 0 = pad)."""
    gens = cfg["target_assigner"]["anchor_generators"]
    gt_boxes, gt_classes, flag = [], [], 0
    for task in cfg["tasks"]:
        nc = task["num_class"]
        tb = np.zeros((batch, max_gt, 9), np.float32)
        tb[..., 3:6] = 1.0
        tc = np.zeros((batch, max_gt), np.int32)
        for b in range(batch):
            for k in range(per_task):
                c = rng.randint(nc)
                g = gens[flag + c]
                size = np.asarray(g["sizes"], np.float32) * rng.uniform(0.9, 1.1, 3)
                tb[b, k] = [rng.uniform(-extent, extent), rng.uniform(-extent, extent),
                            g["anchor_ranges"][2], *size, rng.uniform(-1, 1), rng.uniform(-1, 1),
                            rng.uniform(-3.1, 3.1)]
                tc[b, k] = c + 1
        gt_boxes.append(tb)
        gt_classes.append(tc)
        flag += nc
    return gt_boxes, gt_classes


def library_dw(table, idx, g):
    """Yardstick the port never calls: one index_select of every (tap, row),
    then one batched cuBLAS matmul [Q, R, B*M] x [B*M, Rout]."""
    Bt, Mb, R = table.shape
    Q, M = idx.shape[1], idx.shape[2]
    flat = torch.cat([table.reshape(Bt * Mb, R), table.new_zeros(1, R)])
    base = (torch.arange(Bt, device=idx.device) * Mb)[:, None, None]
    sel = torch.where(idx >= 0, idx.long() + base, Bt * Mb).permute(1, 0, 2).reshape(-1)
    gf = g.reshape(1, Bt * M, -1).expand(Q, Bt * M, g.shape[-1])

    def run():
        gat = flat.index_select(0, sel).view(Q, Bt * M, R)
        return torch.bmm(gat.transpose(1, 2), gf)

    return run


def dw_bound_ms(table, idx, g) -> tuple:
    """(bound ms, "bytes" | "operations") of one weight-gradient launch: table,
    idx and g read once, dw [Q, R, Rout] f32 written once; 2 * hits * R * Rout
    operations."""
    Bt, Mb, R = table.shape
    Q = idx.shape[1]
    Rout = g.shape[-1]
    es = table.element_size()
    nbytes = table.numel() * es + idx.numel() * 4 + g.numel() * es + Q * R * Rout * 4
    hits = int((idx >= 0).sum())
    peak = PEAK_BF16 if es == 2 else PEAK_F32
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, 2.0 * hits * R * Rout / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def plain_input_gradient(table, idx, w, g):
    """d(sum(out * g)) / d(table) by autograd through banded_conv_plain, in
    f32 on f32 copies of the inputs."""
    from dal3d_tpu_torch.ops import banded as bd

    tf = table.float().requires_grad_(True)
    out = bd.banded_conv_plain(tf, idx, w.float())
    out.backward(g.float())
    return tf.grad


def weight_gradient_check(cfg, vf, vc, vv, dev) -> dict:
    """Phase 9. One full-width bf16 train step with every weight-gradient
    launch captured; each is held against banded_dw_plain (both sum the same
    exact bf16 products in f32, in another order: |err| <= 1e-3 x max|plain|)
    and timed with its plain version, its yardstick and its bound. Returns the
    kernels-line numbers, summed over the launches of the step."""
    from dal3d_tpu_torch.models.builder import build_detector
    from dal3d_tpu_torch.ops import banded as bd
    from dal3d_tpu_torch.runtime.steps import make_train_step
    from dal3d_tpu_torch.solver.optim import OneCycleSchedule, build_optimizer

    bundle = build_detector(cfg, seed=0)
    opt = build_optimizer(OneCycleSchedule(total_steps=100)).init(bundle.model.named_parameters())
    step = make_train_step(bundle, opt)
    gt_boxes, gt_classes = random_gt(cfg, np.random.RandomState(9), B, 20, 45.0)
    batch = {"voxel_features": torch.from_numpy(vf).to(torch.bfloat16), "voxel_coords": vc,
             "voxel_valid": vv, "gt_boxes": gt_boxes, "gt_classes": gt_classes}
    bd.banded_conv.launches = 0
    with Capture(bd, "banded_dw") as k3:
        logs = {k: float(v) for k, v in step(batch).items()}
        torch.cuda.synchronize()
    if len(k3.calls) != K3_PER_TRAIN_STEP or bd.banded_conv.launches != K1_PER_TRAIN_STEP:
        fail(f"a train step launched banded_dw {len(k3.calls)}x and banded_conv "
             f"{bd.banded_conv.launches}x; expected {K3_PER_TRAIN_STEP} and {K1_PER_TRAIN_STEP}")
    if not all(np.isfinite(v) for v in logs.values()) or logs["num_pos"] <= 0:
        fail(f"full-width train step: logs {logs}")
    print(f"full-width train step (bf16, B={B}): {logs}")
    del bundle, opt, step

    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0, t_bytes=0.0, t_ops=0.0,
               hits=0.0, slots=0.0)
    worst_abs, worst_rel = 0.0, 0.0
    print("banded_dw launches of one train step, in backward order (kernel vs plain, bf16; "
          "tol = 1e-3 x max|plain|):")
    for n, (table, idx, g) in enumerate(k3.calls):
        got = bd.banded_dw(table, idx, g)
        ref = bd.banded_dw_plain(table, idx, g)
        scale = max(float(ref.abs().max()), 1e-30)
        err = float((got - ref).abs().max())
        if not err <= 1e-3 * scale or not bool(torch.isfinite(got).all()):
            fail(f"banded_dw launch {n} table {tuple(table.shape)} idx {tuple(idx.shape)} "
                 f"g {tuple(g.shape)}: max_abs_err {err:.3e} > {1e-3 * scale:.3e}")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, err / scale)
        ms = cuda_time_ms(lambda: bd.banded_dw(table, idx, g), 5)
        pms = cuda_time_ms(lambda: bd.banded_dw_plain(table, idx, g), 2)
        lms = cuda_time_ms(library_dw(table, idx, g), 2)
        bms, by = dw_bound_ms(table, idx, g)
        hits = int((idx >= 0).sum())
        for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms), ("bound_ms", bms),
                     ("t_" + ("bytes" if by == "bytes" else "ops"), bms), ("hits", hits),
                     ("slots", idx.numel())):
            tot[k] += v
        again = bd.banded_dw(table, idx, g)
        if not torch.equal(got, again):
            fail(f"banded_dw launch {n}: two calls on the same inputs differ")
        print(f"  #{n:2d} table {tuple(table.shape)} idx {tuple(idx.shape)} g {tuple(g.shape)} "
              f"hits {hits}: err {err:.2e} (tol {1e-3 * scale:.2e}) kernel "
              f"{ms:.4f} ms plain {pms:.3f} ms library {lms:.4f} ms bound {bms:.4f} ms ({by}); "
              f"rows compacted away {1.0 - hits / idx.numel():.3f}")
    print(f"banded_dw per train step: kernel {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, "
          f"library {tot['library_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms; rows compacted "
          f"away {1.0 - tot['hits'] / tot['slots']:.3f}; the same bits on a second call; "
          f"max_abs_err {worst_abs:.3e} (max relative to the result's scale {worst_rel:.2e})")

    # three shapes of the path, again in f32: the last L0 subm conv, the ds1
    # strided conv (M != Mb), the deepest subm conv
    def pick(mb, m):
        return next(c for c in k3.calls if c[0].shape[1] == mb and c[1].shape[2] == m
                    and (mb != m or c[1].shape[1] == 9))

    caps = cfg["model"]["backbone"].get("banded_caps", (48000, 17024, 9984, 6016, 6016))
    shapes = [("L0 subm conv", pick(caps[0], caps[0])), ("ds1 strided conv", pick(caps[0], caps[1])),
              ("deep subm conv", pick(caps[3], caps[3]))]
    for tag, (table, idx, g) in shapes:
        tf, gf = table.float(), g.float()
        got, ref = bd.banded_dw(tf, idx, gf), bd.banded_dw_plain(tf, idx, gf)
        scale = max(float(ref.abs().max()), 1e-30)
        err = float((got - ref).abs().max())
        if not err <= 1e-3 * scale:
            fail(f"banded_dw f32 {tag}: max_abs_err {err:.3e} > {1e-3 * scale:.3e}")
        bms, by = dw_bound_ms(tf, idx, gf)
        print(f"  f32 {tag} table {tuple(tf.shape)} idx {tuple(idx.shape)} g {tuple(gf.shape)}: "
              f"err {err:.2e} (tol {1e-3 * scale:.2e}) kernel "
              f"{cuda_time_ms(lambda: bd.banded_dw(tf, idx, gf), 3):.4f} ms plain "
              f"{cuda_time_ms(lambda: bd.banded_dw_plain(tf, idx, gf), 2):.3f} ms library "
              f"{cuda_time_ms(library_dw(tf, idx, gf), 2):.4f} ms bound {bms:.4f} ms ({by})")

    # the input gradient: K1 on the gradient with reversed taps and transposed
    # weights (symmetric rulebooks), matmul + index_add_ (the strided conv),
    # against autograd through the plain forward in f32. The dual gather
    # rounds its f32 sums to bf16 once: one bf16 ulp at the result's scale.
    # The index_add_ route rounds each tap's product to bf16 before the f32
    # scatter-add, as JAX does: up to 8 such roundings meet in a row, 2^-5
    rng = np.random.RandomState(10)
    for tag, (table, idx, g), symmetric in ((shapes[0][0], shapes[0][1], True),
                                            (shapes[2][0], shapes[2][1], True),
                                            (shapes[1][0], shapes[1][1], False)):
        Q, R, Rout = idx.shape[1], table.shape[2], g.shape[2]
        w = torch.from_numpy((rng.randn(Q, R, Rout) * 0.05).astype(np.float32)).to(dev, table.dtype)
        ref = plain_input_gradient(table, idx, w, g)
        if symmetric:
            def run():
                return bd.banded_conv(g, idx, w.flip(0).transpose(1, 2).contiguous())
        else:
            def run():
                return bd.banded_dtable_scatter(g, idx, w, table.shape[1])
        got = run().float()
        scale = max(float(ref.abs().max()), 1e-30)
        err = float((got - ref).abs().max())
        tol = (2.0 ** -7 if symmetric else 2.0 ** -5) * scale
        if got.shape != ref.shape or not err <= tol:
            fail(f"input gradient of the {tag} ({'K1 dual' if symmetric else 'index_add_'}): "
                 f"max_abs_err {err:.3e} > {tol:.3e}")
        print(f"  input gradient of the {tag} by "
              f"{'banded_conv on the gradient (reversed taps, transposed weights)' if symmetric else 'matmul + index_add_'}"
              f": err {err:.2e} (tol {tol:.2e}) against autograd through the plain "
              f"forward; {cuda_time_ms(run, 3):.4f} ms")
    return dict(max_abs_err=worst_abs, ms=tot["ms"], plain_ms=tot["plain_ms"],
                bound_ms=tot["bound_ms"],
                bound_by="bytes" if tot["t_bytes"] >= tot["t_ops"] else "operations",
                library_ms=tot["library_ms"], launches_per_train_step=len(k3.calls))


def gradient_gap(ref: dict, got: dict):
    """Two gradients of one model, by parameter name: the norm of their
    difference over the norm of ``ref``; the worst parameter's largest
    difference over that parameter's largest entry, with its name; and how
    many parameters are beyond 1e-3 by that measure. The conv biases in front
    of a batch norm are left out of the per-parameter figures: no gradient
    flows through the norm to them, what they hold is rounding noise."""
    num = den = worst = 0.0
    worst_name, n_off = "", 0
    for k, g in ref.items():
        d = got[k] - g
        num, den = num + float((d.double() ** 2).sum()), den + float((g.double() ** 2).sum())
        if k.endswith(("conv1.bias", "conv2.bias")):
            continue
        e = float(d.abs().max()) / max(float(g.abs().max()), 1e-30)
        n_off += e > 1e-3
        if e > worst:
            worst, worst_name = e, k
    return (num / max(den, 1e-300)) ** 0.5, worst, worst_name, n_off


def small_f32_train_parity(Config, devices=("cpu", "cuda"), nudge=1e-7) -> str:
    """Phase 10. One f32 train step on a 12.8 m grid (sparse shape
    (41, 64, 64)), production widths, same seeded weights, voxels and boxes:
    the card's kernels against the CPU's plain versions. Loss terms within
    1e-4 relative, updated batch statistics within 1e-4, the gradient as a
    whole within 2e-2 of its norm and its norm within 1e-2.

    Parameter by parameter the two devices do not agree within 1e-3, and the
    step itself is why: its gradient is discontinuous in its inputs at this
    size (units of the 4 x 4 neck maps within rounding of a ReLU's kink move
    single parameters by 1e-1 of their scale). To show it, the step runs a
    third time on the first device alone, each voxel feature scaled by
    1 + ``nudge`` x a normal draw (1e-7: about one f32 ulp); the gap that
    opens there, with no kernel involved, is printed beside the gap between
    the devices. The kernels themselves are held tightly in phase 9."""
    from dal3d_tpu_torch.core.voxel_generator import points_to_voxel_mean as voxelize
    from dal3d_tpu_torch.models.builder import build_detector
    from dal3d_tpu_torch.runtime.steps import make_train_step
    from dal3d_tpu_torch.solver.optim import OneCycleSchedule, build_optimizer

    cfg = Config.fromfile(os.path.join(ROOT, "configs", "cbgs_spatial_temporal.py"))
    cfg["voxel_generator"].update(range=[-6.4, -6.4, -5.0, 6.4, 6.4, 3.0],
                                  voxel_size=[0.2, 0.2, 0.2])
    for g in cfg["target_assigner"]["anchor_generators"]:
        z = g["anchor_ranges"][2]
        g["anchor_ranges"] = [-6.4, -6.4, z, 6.4, 6.4, z]
    cfg["model"]["backbone"].update(dtype="float32", brick_widths=(8, 8, 8, 4, 4),
                                    banded_caps=(1536, 1536, 768, 384, 384))
    rng = np.random.RandomState(12)
    vfs, vcs = [], []
    for _ in range(2):
        pts = rng.uniform([-6.4, -6.4, -3.0, 0, 0], [6.4, 6.4, 1.0, 255, 0],
                          (20000, 5)).astype(np.float32)
        f, c, _ = voxelize(pts, cfg["voxel_generator"]["voxel_size"],
                           cfg["voxel_generator"]["range"], 10, 1500)
        vfs.append(f[:1500])
        vcs.append(c[:1500])
    n = min(len(f) for f in vfs)
    gt_boxes, gt_classes = random_gt(cfg, rng, 2, 1, 5.0, max_gt=8)
    batch = {"voxel_features": np.stack([f[:n] for f in vfs]),
             "voxel_coords": np.stack([c[:n] for c in vcs]),
             "voxel_valid": np.ones((2, n), bool), "gt_boxes": gt_boxes, "gt_classes": gt_classes}
    noise = 1.0 + nudge * rng.standard_normal(batch["voxel_features"].shape)
    nudged = dict(batch, voxel_features=(batch["voxel_features"] * noise).astype(np.float32))
    ref_dev, dev = devices
    logs, grads, stats, sides = {}, {}, {}, {}
    relu = torch.relu

    def recording_relu(x):
        side.append((x > 0).cpu())
        return relu(x)

    for tag, d, data in ((ref_dev, ref_dev, batch), ("card", dev, batch),
                         ("nudged", ref_dev, nudged)):
        bundle = build_detector(cfg, device=d, seed=1)
        opt = build_optimizer(OneCycleSchedule(total_steps=10)).init(
            bundle.model.named_parameters())
        side = sides[tag] = []
        with mock.patch.object(torch, "relu", recording_relu):
            out = make_train_step(bundle, opt)(data)
        logs[tag] = {k: float(v) for k, v in out.items()}
        grads[tag] = {k: p.grad.float().cpu() for k, p in bundle.model.named_parameters()}
        stats[tag] = {k: v.float().cpu() for k, v in bundle.model.state_dict().items()
                      if "running" in k}
    ref = logs[ref_dev]
    if ref["num_pos"] != logs["card"]["num_pos"] or ref["num_pos"] <= 0:
        fail(f"small f32 train step: num_pos {ref['num_pos']} vs {logs['card']['num_pos']}")
    rel = {k: abs(logs["card"][k] - v) / max(abs(v), 1e-30) for k, v in ref.items()}
    fwd_err = max(rel[k] for k in ("loss", "loc_loss", "cls_loss"))
    l2, g_err, g_worst, n_off = gradient_gap(grads[ref_dev], grads["card"])
    nl2, n_err, n_worst, n_n_off = gradient_gap(grads[ref_dev], grads["nudged"])
    s_err = max(float((stats["card"][k] - v).abs().max()) for k, v in stats[ref_dev].items())
    flips = {tag: [(i, tuple(a.shape), int((a != b).sum()))
                   for i, (a, b) in enumerate(zip(sides[ref_dev], sides[tag])) if bool((a != b).any())]
             for tag in ("card", "nudged")}
    tol_l2 = 2e-2
    if fwd_err > 1e-4 or rel["grad_norm"] > 1e-2 or l2 > tol_l2 or s_err > 1e-4:
        fail(f"small f32 train step, {dev} vs {ref_dev}: loss terms differ by {fwd_err:.2e} "
             f"relative, grad_norm by {rel['grad_norm']:.2e} ({logs}), the whole gradient by "
             f"{l2:.2e} of its norm (tol {tol_l2:.2e}; worst parameter {g_worst}: {g_err:.2e} of "
             f"its scale), batch statistics by {s_err:.2e}")
    return (f"{n} voxels x 2, num_pos {logs['card']['num_pos']:.0f}, loss {logs['card']['loss']:.4f} "
            f"({ref_dev} {ref['loss']:.4f}), grad_norm {logs['card']['grad_norm']:.2f} ({ref_dev} "
            f"{ref['grad_norm']:.2f}); loss terms within {fwd_err:.1e} relative (tol 1e-04), "
            f"the whole gradient within {l2:.1e} of its norm (tol {tol_l2:.1e}), {len(stats[ref_dev])} "
            f"batch statistics within {s_err:.1e} (tol 1e-04); parameter by parameter the worst is "
            f"{g_err:.1e} of its scale ({g_worst}), {n_off} of {len(grads[ref_dev])} beyond 1e-3; "
            f"ReLU units on the other side of zero than on {ref_dev} (call, shape, units): "
            f"{flips['card']}. "
            f"The same step on {ref_dev} alone with each voxel feature x (1 + {nudge:.0e} x normal): the "
            f"whole gradient moves by {nl2:.1e} of its norm, the worst parameter by {n_err:.1e} of its "
            f"scale ({n_worst}), {n_n_off} beyond 1e-3; ReLU units that change side: "
            f"{flips['nudged']} of {len(sides[ref_dev])} calls")


def training_run(tmp: str, dev) -> tuple:
    """Phase 11. Returns the launches of each kernel over the first CLI run,
    and the paths of its config and labeled set (for phase 24)."""
    from dal3d_tpu_torch.ops import banded as bd
    from dal3d_tpu_torch.ops import iou_matrix as tiou
    from dal3d_tpu_torch.solver.optim import OneCycleSchedule, build_optimizer
    from dal3d_tpu_torch.runtime.steps import make_train_step
    from dal3d_tpu_torch.tools import active_select, train
    from dal3d_tpu_torch.utils.config import Config

    t0 = time.perf_counter()
    info_path, _ = write_pool(os.path.join(tmp, "nusc_train"), TRAIN_FRAMES, 2, seed=11)
    work_dir = os.path.join(tmp, "work_train")
    buffer_file = os.path.join(tmp, "train_round_buffer.json")
    pred_file = os.path.join(tmp, "train_round_pred.npz")
    cfg_path = os.path.join(tmp, "train.py")
    write_config(cfg_path, dict(type="FeatureSelector", budget=2, buffer_file=buffer_file,
                                infos_origin=info_path, pred_store_file=pred_file,
                                distance_type="l2_ref", streaming=False),
                 extra=f"data['train']['info_path'] = {info_path!r}\n"
                       f"data['train']['root_path'] = ''\ndata['val']['root_path'] = ''\n")
    print(f"labeled set: {TRAIN_FRAMES} frames x 10 lidar files with 0-60 boxes "
          f"({time.perf_counter() - t0:.1f} s)")

    wrappers = {"banded_conv": bd.banded_conv, "banded_dw": bd.banded_dw,
                "iou_matrix": tiou.iou_matrix}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = train.main([cfg_path, "--work_dir", work_dir, "--epochs", "1", "--no_validate",
                          "--seed", "0"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    steps = trainer.step
    expect = {"banded_conv": K1_PER_TRAIN_STEP * steps, "banded_dw": K3_PER_TRAIN_STEP * steps,
              "iou_matrix": 0}
    if steps < 2 or launches != expect:
        fail(f"training run of {steps} steps launched {launches}, expected {expect}")
    cli_peak = torch.cuda.max_memory_allocated() / 1e9
    ckpt_path = os.path.join(work_dir, "checkpoints", "epoch_1.pth")
    if not os.path.isfile(ckpt_path) or trainer.optimizer.count != steps:
        fail(f"training run: no checkpoint at {ckpt_path} or optimizer count "
             f"{trainer.optimizer.count} != {steps}")
    interval = 5  # log_config.interval of the production config
    vals = logged_intervals(work_dir, 1, steps, interval)
    print(f"training CLI, epoch 1: {steps} steps in {cli_s:.1f} s (model build, CBGS resampling "
          f"and checkpoint included); logged every {interval} steps: loss {vals[0, 3]:.3f} -> "
          f"{vals[-1, 3]:.3f}, grad_norm {vals[:, 6].min():.1f}-{vals[:, 6].max():.1f}, num_pos "
          f"{vals[:, 7].min():.0f}-{vals[:, 7].max():.0f}; launches {launches} ({K1_PER_TRAIN_STEP} "
          f"and {K3_PER_TRAIN_STEP} per step expected: {launches['banded_conv'] // steps} and "
          f"{launches['banded_dw'] // steps} counted); peak memory {cli_peak:.2f} GB")

    # resume: the second epoch continues the step count and the schedule
    before = {k: v.clone() for k, v in trainer.bundle.model.state_dict().items()}
    del trainer
    resumed = train.main([cfg_path, "--work_dir", work_dir, "--epochs", "2", "--no_validate",
                          "--seed", "0", "--resume_from", work_dir])
    torch.cuda.synchronize()
    if (resumed.epoch != 2 or resumed.step != 2 * steps or resumed.optimizer.count != 2 * steps
            or not os.path.isfile(os.path.join(work_dir, "checkpoints", "epoch_2.pth"))):
        fail(f"resume: epoch {resumed.epoch}, step {resumed.step}, optimizer count "
             f"{resumed.optimizer.count} after a second epoch of {steps} steps")
    after = resumed.bundle.model.state_dict()
    moved = max(float((after[k].float() - v.float()).abs().max()) for k, v in before.items())
    if not moved > 0 or not all(bool(torch.isfinite(v.float()).all()) for v in after.values()):
        fail("resume: the weights did not move, or are not finite")
    print(f"resume from epoch 1: epoch 2 ends at step {resumed.step}, optimizer count "
          f"{resumed.optimizer.count}, weights finite")
    # iteration time as the CLI logs it: every interval of both epochs but the
    # first, which holds the warm-up (cuDNN's choice of algorithms, the
    # allocator's growth, the kernels' load)
    warm = np.concatenate([vals[1:], logged_intervals(work_dir, 2, steps, interval)])
    print(f"training CLI, iteration as logged ({interval}-step averages; the first interval left "
          f"out, {len(warm)} left): {', '.join(f'{v:.0f}' for v in warm[:, 1] * 1e3)} ms, median "
          f"{np.median(warm[:, 1]) * 1e3:.0f} ms, of which data wait "
          f"{', '.join(f'{v:.0f}' for v in warm[:, 2] * 1e3)} ms, median "
          f"{np.median(warm[:, 2]) * 1e3:.0f} ms")

    # the selection CLI reads the trained checkpoint
    with open(buffer_file, "w") as f:
        json.dump({"0": []}, f)
    active_select.main([cfg_path, "--checkpoint", work_dir, "--seed", "3407"])
    torch.cuda.synchronize()
    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    picks = check_round("selection on the trained checkpoint", buffer_file, info_path, infos, "2")
    emb = np.load(pred_file)["embedding"]
    if emb.shape != (TRAIN_FRAMES, EMB_C) or not np.all(np.isfinite(emb)):
        fail(f"selection on the trained checkpoint: embedding {emb.shape} or not finite")
    print(f"selection CLI on <work_dir>/checkpoints/epoch_2.pth: {len(picks)} picks, pool scores "
          f"finite")

    # a repeated batch: the loss falls; step time and its split
    cfg = Config.fromfile(cfg_path)
    bundle = resumed.bundle
    del resumed
    np.random.seed(5)
    from dal3d_tpu_torch.data import DataLoader, NuScenesDataset
    from dal3d_tpu_torch.models.builder import init_random_, loader_voxelize_cfg

    train_data = dict(cfg["data"]["train"])
    dataset = NuScenesDataset(
        info_path=info_path, root_path="", nsweeps=train_data.get("nsweeps", 10),
        class_names=train_data.get("class_names"),
        pipeline=[dict(s) for s in train_data.get("pipeline", [])],
        tasks=[dict(t) for t in cfg["tasks"]], max_points=cfg.get("max_points", 300000),
        voxelize_host=loader_voxelize_cfg(cfg))
    batch = next(iter(DataLoader(dataset, B, shuffle=False, prefetch=0)))
    batch = {k: v for k, v in batch.items() if k != "metadata"}
    init_random_(bundle.model, torch.Generator().manual_seed(0))
    opt = build_optimizer(OneCycleSchedule(total_steps=200)).init(bundle.model.named_parameters())
    step = make_train_step(bundle, opt)
    losses, step_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out["loss"]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not np.all(np.isfinite(losses)) or not min(losses[-3:]) < losses[0]:
        fail(f"repeated batch: the loss does not fall: {losses}")
    ms_med = float(np.median(step_ms[2:]))
    split = train_step_split(bundle, opt, batch)
    print(f"train step on a repeated batch (B={B}, bf16, {int(batch['voxel_valid'].sum())} voxels): "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} steps; median step "
          f"{ms_med:.2f} ms ({B / ms_med * 1e3:.2f} scans/s); split (synchronized, median of 3): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
          + f"; peak memory {peak:.2f} GB")
    by_name = device_profile(lambda: step(batch), "train step", ms_med)
    for kname in ("banded_conv", "banded_dw"):
        hit = [(name, ms, n) for name, (ms, n) in by_name.items() if kname + "_" in name]
        if hit:
            print(f"  {kname} kernels in the profiled train step: {sum(h[1] for h in hit):.3f} ms "
                  f"over {sum(h[2] for h in hit if 'reduce' not in h[0]):.0f} launches per step")

    # does the loader thread slow the step? The same shuffled epoch through
    # the same warm step, batches made in line (prefetch=0: the wait is the
    # whole preparation, nothing runs beside the step) and by the loader
    # thread the CLI uses (prefetch=2), in the order 0, 2, 2, 0
    for prefetch in (0, 2, 2, 0):
        np.random.seed(5)
        rec, t_data = [], time.perf_counter()
        for b in DataLoader(dataset, B, shuffle=True, seed=0, prefetch=prefetch):
            t_step = time.perf_counter()
            out = step({k: v for k, v in b.items() if k != "metadata"})
            if not np.isfinite(float(out["loss"])):  # also waits for the device
                fail(f"loader-fed step (prefetch={prefetch}): loss {float(out['loss'])}")
            t_end = time.perf_counter()
            rec.append(((t_step - t_data) * 1e3, (t_end - t_step) * 1e3))
            t_data = t_end
        wait, ms = np.median(np.array(rec[2:]), axis=0)
        print(f"  loader-fed steps, {'loader thread (prefetch=2)' if prefetch else 'batches made in line (prefetch=0)'}"
              f": median over {len(rec) - 2} iterations (2 left out): data wait {wait:.0f} ms + step "
              f"{ms:.0f} ms = {wait + ms:.0f} ms an iteration")
    return launches, dict(cfg=cfg_path, info=info_path)


def logged_intervals(work_dir: str, epoch: int, steps: int, interval: int) -> np.ndarray:
    """The trainer's log lines of one epoch as rows (lr, time, data wait,
    loss, loc, cls, grad_norm, num_pos); fails unless there is one line every
    ``interval`` steps, all values finite and positives in each."""
    import re

    with open(os.path.join(work_dir, "train.log")) as f:
        log = f.read()
    lines = re.findall(rf"Epoch \[{epoch}\]\[(\d+)\] lr: ([0-9.]+), time: ([0-9.]+) \(([0-9.]+) data\), "
                       r"loss: ([0-9.naninf]+) \(loc ([0-9.naninf]+) / cls ([0-9.naninf]+)\), "
                       r"grad_norm: ([0-9.naninf]+), num_pos: (\d+)", log)
    if [int(x[0]) for x in lines] != list(range(interval, steps + 1, interval)):
        fail(f"training run: epoch {epoch} logged at steps {[x[0] for x in lines]} for {steps} steps")
    vals = np.array([[float(v) for v in x[1:]] for x in lines])
    if not np.all(np.isfinite(vals)) or vals[:, 7].min() <= 0:
        fail(f"training run: logged values not finite or no positives: {lines}")
    return vals


def train_step_split(bundle, opt, batch) -> dict:
    """Host-clock split of a train step with a synchronize after each part
    (median of 3 after a warm-up): host-to-device copies, forward (with
    target assignment and loss), backward, optimizer (clip + AdamW)."""
    from dal3d_tpu_torch.models.heads.mg_head import multi_group_loss
    from dal3d_tpu_torch.runtime.steps import _to_device, autotuned_convs

    model, dev = bundle.model, bundle.device
    names = ["h2d", "forward+assign+loss", "backward", "optimizer"]
    rec = {n: [] for n in names}
    model.train()
    for _ in range(4):
        marks = [time.perf_counter()]
        vf = _to_device(batch["voxel_features"], dev)
        vc = _to_device(batch["voxel_coords"], dev, torch.int32)
        vv = _to_device(batch["voxel_valid"], dev, torch.bool)
        gt_boxes = [_to_device(b, dev, torch.float32) for b in batch["gt_boxes"]]
        gt_classes = [_to_device(c, dev, torch.int32) for c in batch["gt_classes"]]
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        opt.zero_grad()
        with autotuned_convs():
            out = model(vf, vc, vv)
            labels, targets, _ = bundle.assigner.assign_all(gt_boxes, gt_classes)
            logs = multi_group_loss(out["preds"], labels, targets, bundle.num_classes,
                                    bundle.loss_cfg)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            logs["loss"].backward()
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
        opt.step()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        for n, a, b in zip(names, marks[:-1], marks[1:]):
            rec[n].append((b - a) * 1e3)
    return {n: float(np.median(v[1:])) for n, v in rec.items()}


# ---------------------------------------------------------------------------
# BEVFusion lidar-only (TransFusion-L) predict: the gather engine (K4, K5)
# ---------------------------------------------------------------------------
BF_POINTS, BF_EXTENT = 300_000, 54.0  # configs/bevfusion_lidar.py max_points, +-54 m
K4_PER_PREDICT = 21  # stem, 4 subm convs at each of 4 levels, 3 downsamples, conv_out
K5_PER_PREDICT = 1  # the query gather
K4_TOL = 1e-5  # of the output's scale: 3xTF32 products with f32 sums, in another order than
# the plain matmuls
BF_TOL = 1e-4  # of the scale, for maps and boxes after the whole f32 path


def bevfusion_clouds(seed: int) -> list:
    """Phase 14's B clouds of BF_POINTS lidar-like points over +-BF_EXTENT m,
    [n, 5] each, each in a seeded random point order."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(B):
        p = lidar_cloud(rng, BF_POINTS, BF_EXTENT)
        pts = np.concatenate([p, rng.uniform(0, 255, (len(p), 1)).astype(np.float32),
                              np.zeros((len(p), 1), np.float32)], 1)
        out.append(pts[rng.permutation(len(pts))])
    return out


def bevfusion_batch(seed: int, cfg) -> tuple:
    """Two lidar-like clouds of 300000 points over +-54 m, each in a seeded
    random point order (ground, walls and objects mixed, as a pooled
    multi-sweep frame, instead of generation order, where the first 120000
    voxels would all be ground), voxelized on the host at the config's
    0.075 m. The voxelizer keeps the first ``max_voxel_num`` voxels in
    first-appearance order. Returns (batch, occupied voxels before the cap,
    host seconds)."""
    from dal3d_tpu_torch.core.voxel_generator import points_to_voxel_mean as voxelize

    vg = cfg["voxel_generator"]
    cap = int(vg["max_voxel_num"])
    vf = np.zeros((B, cap, 5), np.float32)
    vc = np.zeros((B, cap, 3), np.int32)
    vv = np.zeros((B, cap), bool)
    occupied = []
    clouds = bevfusion_clouds(seed)
    t0 = time.perf_counter()
    for b, pts in enumerate(clouds):
        # uncapped: the first ``cap`` voxels are the capped voxelizer's output
        f, c, _ = voxelize(pts, vg["voxel_size"], vg["range"], vg["max_points_in_voxel"], len(pts))
        occupied.append(len(f))
        n = min(len(f), cap)
        vf[b, :n], vc[b, :n], vv[b, :n] = f[:n], c[:n], True
    batch = {"voxel_features": torch.from_numpy(vf), "voxel_coords": torch.from_numpy(vc),
             "voxel_valid": torch.from_numpy(vv)}
    return batch, occupied, time.perf_counter() - t0


def gather_gemm_bound_ms(features, idx, hit, w) -> dict:
    """Least times (ms) of one K4 launch: "bytes" (features, idx, hit and
    weights read once, the output written once), "fma" (2 * hits * Cin *
    Cout f32 operations on the FMA units) and "tc" (the same f32-accurate
    products in 3xTF32 on the tensor cores: three TF32 products per f32
    one); "bound" is the larger of the bytes and the lesser operation route,
    "by" what sets it."""
    Bt, _, Cin = features.shape
    M = idx.shape[2]
    Cout = w.shape[-1]
    nbytes = (features.numel() + idx.numel() + w.numel() + Bt * M * Cout) * 4 + hit.numel()
    ops = 2.0 * int(hit.sum()) * Cin * Cout
    t = dict(bytes=nbytes / PEAK_BYTES * 1e3, fma=ops / PEAK_F32 * 1e3,
             tc=3 * ops / PEAK_TF32 * 1e3)
    t_ops = min(t["fma"], t["tc"])
    t["bound"], t["by"] = (t["bytes"], "bytes") if t["bytes"] >= t_ops else (t_ops, "operations")
    return t


def unsorted_walk(hit, cout: int) -> int:
    """(row, tap) pairs of an unsorted walk for one column tile: rows in
    rulebook order, tiles of 256 rows (Cout 16), 128 (32, 64) or 64 (128),
    every tap with a hit in the tile over all of its rows (the walk of the
    kernel's FMA version, before 3xTF32)."""
    from dal3d_tpu_torch.ops.gather import _cout_pad

    c = _cout_pad(cout)
    bm = 256 if c == 16 else (128 if c <= 64 else 64)
    Bt, K, M = hit.shape
    T = -(-M // bm)
    h = torch.nn.functional.pad(hit, (0, T * bm - M))
    return int(h.view(Bt, K, T, bm).any(-1).sum()) * bm


def k4_case(tg, dev, B_, N, Cin, K, M, Cout, seed, hit_p=0.5, span=0.0) -> float:
    """One awkward K4 case against the plain version (rows 100-299 without
    a hit must come out zero; ``span`` spreads the features over 10^-span
    to 10^span), bit-equal on a second call and on the sorted plan; returns
    the error relative to scale."""
    rng = np.random.RandomState(seed)
    f = rng.randn(B_, N, Cin) * 10.0 ** rng.uniform(-span, span, (B_, N, Cin))
    f = torch.from_numpy(f.astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.randint(0, N, (B_, K, M)).astype(np.int32)).to(dev)
    hit = torch.from_numpy(rng.rand(B_, K, M) < hit_p).to(dev)
    hit[:, :, 100:300] = False
    w = torch.from_numpy((rng.randn(K, Cin, Cout) * 0.1).astype(np.float32)).to(dev)
    got, ref = tg.gather_gemm(f, idx, hit, w), tg.gather_gemm_plain(f, idx, hit, w)
    rel = float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
    if not rel <= K4_TOL or (M > 100 and float(got[:, 100:300].abs().max()) != 0.0):
        fail(f"gather_gemm awkward case {(B_, N, Cin, K, M, Cout)}: error {rel:.2e} of scale")
    if not (torch.equal(got, tg.gather_gemm(f, idx, hit, w))
            and torch.equal(got, tg.gather_gemm(f, idx, hit, w, tg.gather_plan(idx, hit)))):
        fail(f"gather_gemm awkward case {(B_, N, Cin, K, M, Cout)}: a second call, or the call "
             "on the sorted plan, differs")
    return rel


def host_us(fn, n: int = 200) -> float:
    """Host microseconds per call of ``fn``: the enqueue, not the device
    work (nothing synchronizes inside the window, and the launch queue does
    not fill at these counts)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def bound_per_call(name: str, fn_name: str, argtypes, device, args):
    """A launch bound on every call, for the host-time comparison only:
    the library looked up, ctypes argtypes and restype set, the device guard
    entered and torch.cuda.current_stream() asked, on every call."""
    import ctypes

    from dal3d_tpu_torch.ops import _build

    lib = _build.load(name)
    fn = getattr(lib, fn_name)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, fn_name)


def launch_host_us(name: str, fn_name: str, argtypes, device, args) -> tuple:
    """(bound once, bound per call) host us of one C launch with the same
    arguments: what the bind-once helper takes off every wrapper call."""
    from dal3d_tpu_torch.ops import _build

    once = _build.function(name, fn_name, argtypes)
    return (host_us(lambda: once(device, *args)),
            host_us(lambda: bound_per_call(name, fn_name, argtypes, device, args)))


def gather_kernels_check(bundle, batch, bd, tg) -> dict:
    """Phase 12: every K4 / K5 launch of one full-width predict against its
    plain version and bit-equal on a repeat, with times, both bounds, the
    walk (pairs multiplied against hits, and against an unsorted walk),
    the plans' cost once per rulebook, yardsticks; awkward small cases."""
    import ctypes

    from dal3d_tpu_torch.runtime.bevfusion_steps import make_bevfusion_predict_step

    predict = make_bevfusion_predict_step(bundle)
    with Capture(tg, "gather_gemm") as k4, Capture(tg, "gather_rows") as k5:
        predict(batch)
        torch.cuda.synchronize()
    if len(k4.calls) != K4_PER_PREDICT or len(k5.calls) != K5_PER_PREDICT:
        fail(f"capture run launched gather_gemm {len(k4.calls)}x, gather_rows {len(k5.calls)}x; "
             f"expected {K4_PER_PREDICT} and {K5_PER_PREDICT}")
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, k1_ms=0.0, bound_ms=0.0, t_bytes=0.0,
               t_ops=0.0, fma_ms=0.0, tc_ms=0.0, hits=0, dense=0, walked=0, unsorted=0,
               steps=0, plan_ms=0.0, plan_host_ms=0.0, plans=0, flops=0.0)
    worst_abs = worst_rel = 0.0
    print(f"gather_gemm launches of one predict (kernel vs plain, f32; tol = {K4_TOL:g} x "
          "max|plain|, and bit-equal on a second call; library = index_select + one matmul over "
          "K*Cin; K1 = banded_conv's f32 path on the same rulebook; bounds: bytes, f32 FMA, "
          "3xTF32 tensor cores; walked = (row, tap) pairs the warps multiply as gemm_walk models "
          "the walk / hits, unsorted = "
          "the same for rulebook-order tiles of 256/128/64 rows; TFLOP/s = 2 hits Cin Cout / "
          "kernel time):")
    prev = None
    for n, (f, idx, hit, w, plan) in enumerate(k4.calls):
        Cin, Cout = f.shape[-1], w.shape[-1]
        shared = prev is not None and prev[0].shape == idx.shape and torch.equal(
            prev[0], idx) and torch.equal(prev[1], hit)
        if plan is None:  # a rulebook used once: the wrapper's plan keeps the rows' order
            plan = tg.gather_plan(idx, hit, sort=False)
        if not shared:  # a new rulebook: its plan is made once, here timed once
            sort = plan.order is not None
            pms_ = cuda_time_ms(lambda: tg.gather_plan(idx, hit, sort), 5)
            phu = host_us(lambda: tg.gather_plan(idx, hit, sort), 20)
            tot["plan_ms"] += pms_
            tot["plan_host_ms"] += phu / 1e3
            tot["plans"] += 1
            kind = ("hit-mask sort and fold, shared by the launches after it" if sort
                    else "fold only, rows in order: used once")
            print(f"  plan of the rulebook {tuple(idx.shape)} ({kind}): {pms_:.4f} ms on the "
                  f"device, {phu:.1f} us on the host")
        prev = (idx, hit)
        got, ref = tg.gather_gemm(f, idx, hit, w, plan), tg.gather_gemm_plain(f, idx, hit, w)
        scale = max(float(ref.abs().max()), 1e-30)
        err = float((got - ref).abs().max())
        if not err <= K4_TOL * scale:
            fail(f"gather_gemm launch {n} {tuple(f.shape)}x{tuple(w.shape)}: max_abs_err "
                 f"{err:.3e} > {K4_TOL * scale:.3e}")
        if not torch.equal(got, tg.gather_gemm(f, idx, hit, w, plan)):
            fail(f"gather_gemm launch {n}: a second call on the same inputs differs")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, err / scale)
        rb = torch.where(hit, idx, -1)  # the yardsticks' rulebook
        ms = cuda_time_ms(lambda: tg.gather_gemm(f, idx, hit, w, plan), 5)
        pms = cuda_time_ms(lambda: tg.gather_gemm_plain(f, idx, hit, w), 2)
        lms = cuda_time_ms(library_banded(f, rb, w), 2)
        k1ms = cuda_time_ms(lambda: bd.banded_conv(f, rb, w), 3)
        bnd = gather_gemm_bound_ms(f, idx, hit, w)
        hits = int(hit.sum())
        blocks, groups = tg.gemm_walk(plan, Cout)
        walked = int(groups.sum()) * tg.gemm_tile_rows(Cout)[1]
        old = unsorted_walk(hit, Cout)
        flops = 2.0 * hits * Cin * Cout
        for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms), ("k1_ms", k1ms),
                     ("bound_ms", bnd["bound"]), ("fma_ms", bnd["fma"]), ("tc_ms", bnd["tc"]),
                     ("hits", hits), ("dense", hit.numel()), ("walked", walked),
                     ("unsorted", old), ("steps", int(blocks.sum())), ("flops", flops)):
            tot[k] += v
        tot["t_" + ("bytes" if bnd["by"] == "bytes" else "ops")] += bnd["bound"]
        print(f"  #{n:2d} features {tuple(f.shape)} taps {idx.shape[1]} M {idx.shape[2]} Cout "
              f"{Cout} hits {hits} ({hits / hit.numel():.3f}): err {err / scale:.1e} of scale, "
              f"repeat bit-equal; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s on hits) "
              f"plain {pms:.3f} library {lms:.4f} K1 f32 {k1ms:.4f}; bounds bytes "
              f"{bnd['bytes']:.4f} fma {bnd['fma']:.4f} 3xtf32 {bnd['tc']:.4f} -> "
              f"{bnd['bound']:.4f}"
              f" ms ({bnd['by']}); walked {walked / hits:.2f} x hits (unsorted {old / hits:.2f}), "
              f"{int(blocks.sum())} (block, tap) steps")
    tot["bound_by"] = "bytes" if tot["t_bytes"] >= tot["t_ops"] else "operations"
    k4_ms = tot["ms"] + tot["plan_ms"]
    print(f"gather_gemm plans: {tot['plans']} rulebooks, {tot['plan_ms']:.3f} ms of device time "
          f"per predict ({tot['plan_host_ms']:.3f} ms on the host)")
    print(f"gather_gemm per predict: {k4_ms:.3f} ms (kernel {tot['ms']:.3f} + plans "
          f"{tot['plan_ms']:.3f}), {tot['flops'] / tot['ms'] / 1e9:.1f} TFLOP/s on hits; plain "
          f"{tot['plain_ms']:.3f} ms, library {tot['library_ms']:.3f} ms, K1 f32 "
          f"{tot['k1_ms']:.3f} ms; bound {tot['bound_ms']:.3f} ms ({tot['bound_by']}; operation "
          f"routes: f32 FMA {tot['fma_ms']:.3f}, 3xTF32 {tot['tc_ms']:.3f}); hits {tot['hits']} "
          f"of {tot['dense']} (row, tap) pairs, walked (as gemm_walk models it) "
          f"{tot['walked'] / tot['hits']:.3f} x hits (unsorted {tot['unsorted'] / tot['hits']:.3f}); "
          f"max_abs_err {worst_abs:.3e} "
          f"(relative to output scale {worst_rel:.2e})")

    # K5: the query gather from the [B, H*W, C] view of the NCHW map
    table, rows = k5.calls[0]
    Bt, R, C = table.shape
    flat = table.reshape(Bt * R, C)  # a contiguous copy
    got = tg.gather_rows(table, rows)
    if not (torch.equal(got, flat[rows.long()])
            and torch.equal(got, tg.gather_rows_plain(table, rows))):
        fail("gather_rows main-path launch differs from table[idx]")
    bi = torch.div(rows.long(), R, rounding_mode="floor")
    ri = torch.remainder(rows.long(), R)
    k5n = dict(ms=cuda_time_ms(lambda: tg.gather_rows(table, rows), 50),
               plain_ms=cuda_time_ms(lambda: tg.gather_rows_plain(table, rows), 50),
               library_ms=cuda_time_ms(lambda: table[bi, ri], 50),
               copy_index_select_ms=cuda_time_ms(
                   lambda: torch.index_select(table.reshape(Bt * R, C), 0, rows), 50),
               max_abs_err=0.0, bound_by="bytes")
    nbytes = rows.numel() * 4 + 2 * rows.numel() * C * table.element_size()
    k5n["bound_ms"] = nbytes / PEAK_BYTES * 1e3
    k5n["host_us"] = host_us(lambda: tg.gather_rows(table, rows))
    k5n["library_host_us"] = host_us(lambda: table[bi, ri])
    out = torch.empty(rows.numel(), C, device=table.device)
    es = table.element_size()
    k5_args = (table.data_ptr(), rows.data_ptr(), out.data_ptr(), rows.numel(), Bt * R, R,
               table.stride(0) * es, table.stride(1) * es, table.stride(2) * es, es, C * es)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    once, per_call = launch_host_us("gather", "gather_rows", [P] * 3 + [I] + [L] * 5 + [I] * 2,
                                    table.device, k5_args)
    print(f"gather_rows view {tuple(table.shape)} strides {table.stride()} idx "
          f"{tuple(rows.shape)}: bit-equal to table[idx] on a contiguous copy; kernel "
          f"{k5n['ms']:.4f} ms, plain {k5n['plain_ms']:.4f} ms, advanced indexing on the view "
          f"{k5n['library_ms']:.4f} ms, the old path (reshape copy + index_select) "
          f"{k5n['copy_index_select_ms']:.4f} ms, bound {k5n['bound_ms']:.5f} ms (bytes); host "
          f"us per call: wrapper {k5n['host_us']:.2f}, advanced indexing "
          f"{k5n['library_host_us']:.2f}; the C launch alone bound once {once:.2f} vs bound per "
          f"call with guard and stream lookup {per_call:.2f}")

    dev = table.device
    rels = [k4_case(tg, dev, 1, 300, 5, 27, 777, 16, 1), k4_case(tg, dev, 1, 50, 32, 3, 1, 128, 2),
            k4_case(tg, dev, 2, 400, 64, 27, 333, 64, 3),
            k4_case(tg, dev, 2, 5000, 128, 27, 4000, 128, 5, hit_p=0.19, span=3.0),
            k4_case(tg, dev, 1, 100, 12, 4, 300, 200, 6)]
    rng = np.random.RandomState(4)
    for C_, M_, dtype in ((5, 33, torch.float32), (128, 1, torch.float32), (3, 7, torch.bfloat16)):
        tbl = torch.from_numpy(rng.randn(100, C_).astype(np.float32)).to(dev, dtype)
        ix = torch.from_numpy(rng.randint(0, 100, M_).astype(np.int32)).to(dev)
        if not torch.equal(tg.gather_rows(tbl, ix), tbl[ix.long()]):
            fail(f"gather_rows awkward case C={C_} M={M_} {dtype} differs from table[idx]")
        v = tbl[:, 1:]  # rows not 16-byte aligned
        if C_ > 1 and not torch.equal(tg.gather_rows(v, ix), v[ix.long()]):
            fail(f"gather_rows awkward case C={C_} M={M_} {dtype} on an unaligned view differs")
    print(f"awkward cases: gather_gemm (Cin 5, M 777, 27 taps, rows without a hit), (M 1, "
          f"Cout 128), (Cin 64, M 333), (Cin 128, 19 % hits, features over 1e-3..1e3), (Cout 200) "
          f"within {max(rels):.1e} of scale, bit-equal on a repeat and on the sorted plan; "
          "gather_rows (C 5, M 33), "
          "(M 1), (bf16, C 3) and their unaligned views bit-equal")
    k4 = dict(max_abs_err=worst_abs, ms=k4_ms, plain_ms=tot["plain_ms"],
              bound_ms=tot["bound_ms"], bound_by=tot["bound_by"], library_ms=tot["library_ms"],
              kernel_ms=tot["ms"], plan_ms=tot["plan_ms"], plan_host_ms=tot["plan_host_ms"],
              k1_f32_ms=tot["k1_ms"],
              bound_fma_ms=tot["fma_ms"], bound_3xtf32_ms=tot["tc_ms"])
    return {"gather_gemm": k4, "gather_rows": k5n}


def bevfusion_tiny_cfg() -> dict:
    """The tiny lidar-only model of the CPU parity tests on a (41, 64, 64)
    grid (12.8 m at 0.2 m)."""
    return {"model": dict(type="BEVFusion", with_camera=False, num_proposals=8,
                          decoder_channels=(16, 32), decoder_layer_nums=(1, 1),
                          neck_out_channels=(16, 16), hidden_channel=16, ffn_channel=32,
                          num_heads=2, voxel_caps=(2000, 1000, 500, 500)),
            "voxel_generator": dict(range=[-6.4, -6.4, -5.0, 6.4, 6.4, 3.0],
                                    voxel_size=[0.2, 0.2, 0.2], max_points_in_voxel=10,
                                    max_voxel_num=1800),
            "test_cfg": dict(out_size_factor=8, voxel_size=[0.2, 0.2], pc_range=[-6.4, -6.4])}


def small_bevfusion_parity(tg) -> str:
    """Phase 13: the tiny f32 BEVFusion predict on the card (kernels) and on
    the CPU (plain versions), same seeded weights and host voxels: equal
    query pixels and labels, boxes and scores within BF_TOL of max(1, |x|)."""
    from dal3d_tpu_torch.core.voxel_generator import points_to_voxel_mean as voxelize
    from dal3d_tpu_torch.models.builder import build_bevfusion
    from dal3d_tpu_torch.runtime.bevfusion_steps import make_bevfusion_predict_step

    cfg = bevfusion_tiny_cfg()
    vg = cfg["voxel_generator"]
    rng = np.random.RandomState(3)
    vf = np.zeros((B, 1800, 5), np.float32)
    vc = np.zeros((B, 1800, 3), np.int32)
    vv = np.zeros((B, 1800), bool)
    for b in range(B):
        pts = rng.uniform([-6.4, -6.4, -3.0, 0, 0], [6.4, 6.4, 1.0, 255, 0],
                          (6000, 5)).astype(np.float32)
        f, c, _ = voxelize(pts, vg["voxel_size"], vg["range"], 10, 1800)
        vf[b, :len(f)], vc[b, :len(f)], vv[b, :len(f)] = f, c, True
    batch = {"voxel_features": vf, "voxel_coords": vc, "voxel_valid": vv}
    outs, rows = {}, {}
    for d in ("cpu", "cuda"):
        with Capture(tg, "gather_rows") as rec:
            o = make_bevfusion_predict_step(build_bevfusion(cfg, device=d, seed=1))(batch)
        outs[d] = {k: v.float().cpu() for k, v in o.items()}
        rows[d] = rec.calls[0][1].cpu()
    a, b = outs["cpu"], outs["cuda"]
    if not torch.equal(rows["cpu"], rows["cuda"]) or not torch.equal(a["label_preds"],
                                                                     b["label_preds"]):
        diff = (rows["cpu"] != rows["cuda"]).nonzero().flatten().tolist()
        gaps = [abs(float(a["scores"].flatten()[i] - b["scores"].flatten()[i])) for i in diff]
        fail(f"small BEVFusion predict: query pixels or labels differ at {diff} "
             f"(score gaps {gaps})")
    box = float(((a["box3d_lidar"] - b["box3d_lidar"]).abs()
                 / a["box3d_lidar"].abs().clamp(min=1.0)).max())
    sc = float((a["scores"] - b["scores"]).abs().max())
    bev = float((a["bev_feat"] - b["bev_feat"]).abs().max()) / float(a["bev_feat"].abs().max())
    if box > BF_TOL or sc > BF_TOL or bev > BF_TOL:
        fail(f"small BEVFusion predict: box err {box:.2e}, score err {sc:.2e}, bev map {bev:.2e} "
             f"(tol {BF_TOL:g})")
    return (f"{int(vv.sum())} voxels; {rows['cpu'].numel()} query pixels and labels equal; box "
            f"err {box:.1e} of max(1,|x|), score err {sc:.1e}, bev map err {bev:.1e} of scale")


def bevfusion_forward(bundle, batch, tg, k4, k5, stop_at=""):
    """One forward (and decode) with the K4 / K5 wrappers set to k4 / k5;
    returns (preds, decoded, query rows)."""
    from dal3d_tpu_torch.models.bevfusion import transfusion_decode
    from dal3d_tpu_torch.runtime.bevfusion_steps import (_forward, autotuned_convs,
                                                         bevfusion_inputs)

    inputs = bevfusion_inputs(bundle.model, batch, bundle.device)
    saved = tg.gather_gemm, tg.gather_rows
    tg.gather_gemm, tg.gather_rows = k4, k5
    try:
        with Capture(tg, "gather_rows") as rec, torch.inference_mode(), autotuned_convs():
            preds = _forward(bundle.model, inputs, stop_at)
            dec = transfusion_decode(preds, bundle.test_cfg) if not stop_at else None
        torch.cuda.synchronize()
    finally:
        tg.gather_gemm, tg.gather_rows = saved
    return preds, dec, (rec.calls[0][1] if rec.calls else None)


def bevfusion_plain_check(bundle, batch, tg, maps=("lidar",)) -> str:
    """The main path once more with both kernels swapped for their plain
    versions (same weights, same inputs): the maps of the ``maps`` cuts
    (``stop_at``), the neck map and the heatmap within BF_TOL of their
    scale; the queries matched by (pixel, class), their boxes, scores and
    class logits within BF_TOL of max(1, |x|). A query present on one side
    only must sit at the top-200 boundary: its score within 1e-5 of the
    other side's 200th."""
    kern = (tg.gather_gemm, tg.gather_rows)
    plain = (lambda f, idx, hit, w, plan=None: tg.gather_gemm_plain(f, idx, hit, w),
             tg.gather_rows_plain)
    cuts = [(f"{m} map", bevfusion_forward(bundle, batch, tg, *kern, stop_at=m)[0][m],
             bevfusion_forward(bundle, batch, tg, *plain, stop_at=m)[0][m]) for m in maps]
    pk, dk, rk = bevfusion_forward(bundle, batch, tg, *kern)
    pp, dp, rp = bevfusion_forward(bundle, batch, tg, *plain)
    report = []
    for name, a, b in cuts + [("neck map", pk["bev_feat"], pp["bev_feat"]),
                              ("heatmap", pk["heatmap"], pp["heatmap"])]:
        rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        if not rel <= BF_TOL:
            fail(f"BEVFusion main path vs plain: {name} error {rel:.3e} of scale > {BF_TOL:g}")
        report.append(f"{name} {rel:.1e}")
    P = pk["query_score"].shape[1]
    HW = pk["heatmap"].shape[1] * pk["heatmap"].shape[2]
    box_err = sc_err = logit_err = 0.0
    flips = 0
    for b in range(pk["query_score"].shape[0]):
        key_k = (pk["query_labels"][b].long() * HW + rk.view(-1, P)[b] - b * HW).tolist()
        key_p = (pp["query_labels"][b].long() * HW + rp.view(-1, P)[b] - b * HW).tolist()
        pos_p = {k: i for i, k in enumerate(key_p)}
        for i, k in enumerate(key_k):
            j = pos_p.get(k)
            if j is None:
                flips += 1
                gap = abs(float(pk["query_score"][b, i] - pp["query_score"][b, -1]))
                if gap > 1e-5:
                    fail(f"BEVFusion main path vs plain: query {i} of sample {b} (key {k}) only "
                         f"on the kernel side, score gap to the plain 200th {gap:.2e}")
                continue
            ba, bb_ = dk["box3d_lidar"][b, i].double(), dp["box3d_lidar"][b, j].double()
            box_err = max(box_err, float(((ba - bb_).abs() / bb_.abs().clamp(min=1.0)).max()))
            sc_err = max(sc_err, abs(float(dk["scores"][b, i] - dp["scores"][b, j])))
            la, lb = pk["cls_logits"][b, i].double(), pp["cls_logits"][b, j].double()
            logit_err = max(logit_err, float(((la - lb).abs() / lb.abs().clamp(min=1.0)).max()))
    if box_err > BF_TOL or sc_err > BF_TOL or logit_err > BF_TOL:
        fail(f"BEVFusion main path vs plain: matched detections box err {box_err:.2e}, score "
             f"err {sc_err:.2e}, cls_logits err {logit_err:.2e} (tol {BF_TOL:g})")
    return (f"{', '.join(report)} of scale; {2 * P - flips} of {2 * P} queries matched by (pixel, "
            f"class) (flips at the top-{P} boundary: {flips}), box err {box_err:.1e}, score "
            f"err {sc_err:.1e}, cls_logits err {logit_err:.1e}")


def bevfusion_stage_split(bundle, batch, k4_ms: float) -> None:
    """Host-clock split of one predict with a synchronize after each stage
    (median of 5 after one warm-up); the lidar branch is also shown without
    phase 12's K4 time (index grids, rulebooks, plans, norms, to_dense)."""
    from dal3d_tpu_torch.models.bevfusion import transfusion_decode
    from dal3d_tpu_torch.runtime.bevfusion_steps import autotuned_convs

    model, dev = bundle.model, bundle.device
    names = ["h2d", "lidar", "decoder", "head", "decode"]
    rec = {n: [] for n in names}
    with torch.inference_mode(), autotuned_convs():
        for _ in range(6):
            marks = [time.perf_counter()]
            vf, vc, vv = (batch[k].to(dev) for k in ("voxel_features", "voxel_coords",
                                                      "voxel_valid"))
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            lidar = model(vf, vc, vv, stop_at="lidar")["lidar"]
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            bev = model.neck(model.decoder(lidar))
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            preds = model.head(bev)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            transfusion_decode(preds, bundle.test_cfg)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            for n, a, b in zip(names, marks[:-1], marks[1:]):
                rec[n].append((b - a) * 1e3)
    med = {n: float(np.median(v[1:])) for n, v in rec.items()}
    print(f"BEVFusion stage split (ms, median of 5, synchronized per stage): "
          f"{', '.join(f'{n} {v:.2f}' for n, v in med.items())}; lidar without K4 "
          f"({k4_ms:.2f} ms in phase 12): {med['lidar'] - k4_ms:.2f}")


def bevfusion_loader_frames(tmp: str, cfg, predict) -> None:
    """4 frames of a synthetic nuScenes infos file (data/datasets/synthetic.py:
    300000 points per frame over +-54 m) through the port's NuScenesDataset
    with the config's test pipeline and host voxelization, and its loader (in
    line), into the predict step."""
    from dal3d_tpu_torch.data.datasets.nuscenes import NuScenesDataset
    from dal3d_tpu_torch.data.datasets.synthetic import make_synthetic_nuscenes
    from dal3d_tpu_torch.data.loader import DataLoader

    root = os.path.join(tmp, "bevfusion_frames")
    info = make_synthetic_nuscenes(root, n_frames=4, n_logs=1, points_per_frame=BF_POINTS,
                                   seed=5, range_xy=BF_EXTENT - 5.0)
    val = cfg["data"]["val"]
    ds = NuScenesDataset(info_path=info, root_path=root, nsweeps=val["nsweeps"],
                         class_names=val["class_names"], test_mode=True,
                         pipeline=[dict(st) for st in val["pipeline"]],
                         tasks=[dict(t) for t in cfg["tasks"]], max_points=cfg["max_points"],
                         voxelize_host=dict(cfg["voxel_generator"]))
    it = iter(DataLoader(ds, batch_size=B, shuffle=False, drop_last=False, prefetch=0))
    lines = []
    for _ in range(len(ds) // B):
        t0 = time.perf_counter()
        batch = next(it)
        t1 = time.perf_counter()
        out = predict(batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if tuple(out["box3d_lidar"].shape) != (B, 200, 9) or not bool(
                torch.isfinite(out["box3d_lidar"]).all()) or int(out["det_valid"].sum()) == 0:
            fail("loader-fed BEVFusion predict: bad output")
        lines.append(f"voxels {[int(v) for v in batch['voxel_valid'].sum(1)]}, preparation "
                     f"{(t1 - t0) * 1e3:.0f} ms, predict {(t2 - t1) * 1e3:.1f} ms")
    print(f"loader-fed frames ({len(ds)} through the test pipeline, batches of {B}): "
          + "; ".join(lines))


def bevfusion_main_path(tmp: str, Config, counters, tg, bd) -> dict:
    """Phases 12-14: the BEVFusion predict at full width. Returns the
    kernels-line numbers of K4 and K5 and their main-path launches, and the
    predict's median ms."""
    from dal3d_tpu_torch.models.builder import build_bevfusion
    from dal3d_tpu_torch.runtime.bevfusion_steps import make_bevfusion_predict_step

    cfg = Config.fromfile(os.path.join(ROOT, "configs", "bevfusion_lidar.py"))
    batch, occupied, host_s = bevfusion_batch(10, cfg)
    cap = int(cfg["voxel_generator"]["max_voxel_num"])
    print(f"BEVFusion inputs: B={B}, {BF_POINTS} points/cloud over +-{BF_EXTENT} m in a seeded "
          f"random order -> occupied voxels {occupied} at 0.075 m, the first {cap} kept "
          f"({host_s:.2f} s host voxelization)")
    bundle = build_bevfusion(cfg, seed=0)
    print(f"BEVFusion model: {sum(p.numel() for p in bundle.model.parameters())} parameters, "
          f"sparse shape {bundle.voxel_cfg.sparse_shape}, caps "
          f"{[s.down.out_cap for s in bundle.model.encoder.stages[:3]]}")

    # 12. K4 / K5 launch by launch
    numbers = gather_kernels_check(bundle, batch, bd, tg)

    # 13. small f32 BEVFusion predict: card (kernels) vs CPU (plain versions)
    print(f"small f32 BEVFusion predict, card vs CPU: {small_bevfusion_parity(tg)}")

    # 14. the main path
    predict = make_bevfusion_predict_step(bundle)
    for c in counters:
        c.launches = 0
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
    launches = {c.__name__: c.launches for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {n: 0 for n in launches}
    want.update(gather_gemm=K4_PER_PREDICT * n_runs, gather_rows=K5_PER_PREDICT * n_runs)
    if launches != want:
        fail(f"BEVFusion main path launched {launches} in {n_runs} predicts; expected {want}")
    shapes = {"box3d_lidar": (B, 200, 9), "scores": (B, 200), "label_preds": (B, 200),
              "det_valid": (B, 200), "bev_feat": (B, 180, 180, 512)}
    for k, shp in shapes.items():
        if tuple(out[k].shape) != shp:
            fail(f"BEVFusion output {k} has shape {tuple(out[k].shape)}, expected {shp}")
        if out[k].is_floating_point() and not bool(torch.isfinite(out[k]).all()):
            fail(f"BEVFusion output {k} is not finite")
    n_det = [int(x) for x in out["det_valid"].sum(1)]
    if min(n_det) == 0:
        fail(f"BEVFusion: no detections {n_det}")
    ms_med = float(np.median(times))
    print(f"BEVFusion predict (B={B}): median {ms_med:.2f} ms, mean {np.mean(times):.2f} ms, "
          f"min {min(times):.2f} ms over {TIMED_ITERS} iterations -> {B / ms_med * 1e3:.2f} "
          f"scans/s; peak memory {peak_gb:.2f} GB; detections {n_det}, scores "
          f"{float(out['scores'].min()):.3f}-{float(out['scores'].max()):.3f}; launches "
          f"gather_gemm {launches['gather_gemm']} gather_rows {launches['gather_rows']} in "
          f"{n_runs} predicts, no other kernel")
    print(f"BEVFusion main path vs the same path on plain versions: "
          f"{bevfusion_plain_check(bundle, batch, tg)}")
    bevfusion_stage_split(bundle, batch, numbers["gather_gemm"]["ms"])
    device_profile(lambda: predict(batch), "BEVFusion predict", ms_med)
    bevfusion_loader_frames(tmp, cfg, predict)
    numbers["gather_gemm"]["launches"] = launches["gather_gemm"]
    numbers["gather_rows"]["launches"] = launches["gather_rows"]
    numbers["predict_ms"] = ms_med
    return numbers


# ---------------------------------------------------------------------------
# the AL loop through the CLIs: data preparation, GT-AUG, train with its val
# phase, evaluation, two selection rounds
# ---------------------------------------------------------------------------

LOOP_FRAMES, LOOP_BUDGET, LOOP_SEED = 16, 3, 7


def write_loop_config(path: str, root: str, buffer_file: str, work_dir: str,
                      extra: str = "") -> None:
    """The production base (configs/_cbgs_base.py: its model at full width,
    its GT-AUG sampler and its workflow with a val phase) pointed at the
    synthetic set under ``root``, with a FeatureSelector on the L2 k-center
    for the model-based round. The base module's dicts are shared by every
    load in this process, so the config copies what it changes."""
    info = os.path.join(root, "infos_{}_10sweeps_withvelo.pkl")
    with open(path, "w") as f:
        f.write(f"import copy, sys\nsys.path.insert(0, {os.path.join(ROOT, 'configs')!r})\n"
                "from _cbgs_base import *  # noqa: F401,F403\n"
                "data = copy.deepcopy(data)\n"
                f"data['train'].update(root_path={root!r}, info_path={info.format('train')!r})\n"
                f"data['val'].update(root_path={root!r}, info_path={info.format('val')!r})\n"
                "data['train']['pipeline'][2]['cfg']['db_sampler']['db_info_path'] = "
                f"{os.path.join(root, 'dbinfos_train_10sweeps_withvelo.pkl')!r}\n"
                f"work_dir = {work_dir!r}\n"
                f"selector = dict(type='FeatureSelector', budget={LOOP_BUDGET}, "
                f"buffer_file={buffer_file!r}, infos_origin={info.format('train')!r}, "
                "distance_type='l2', streaming=False)\n" + extra)


class IouRecorder:
    """Wraps the evaluation's IoU functions where ``eval/kitti_eval.py`` looks
    them up (``ops.rotated_iou.rotated_iou_matrix`` / ``boxes_iou3d``):
    every call's inputs and output go to the host, its time (synchronized)
    is summed."""

    def __init__(self, module):
        self.module, self.calls, self.seconds = module, [], 0.0

    def __enter__(self):
        self.orig = {n: getattr(self.module, n) for n in ("rotated_iou_matrix", "boxes_iou3d")}

        def wrap(name, fn):
            def call(a, b, *args):
                sync = a.is_cuda
                if sync:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(a, b, *args)
                if sync:
                    torch.cuda.synchronize()
                self.seconds += time.perf_counter() - t0
                self.calls.append((name, a.cpu(), b.cpu(), out.cpu(), a.device.type))
                return out
            return call

        for n, fn in self.orig.items():
            setattr(self.module, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.module, n, fn)


def loop_round(tag: str, buffer_file: str, info_path: str, n_rounds: int) -> tuple:
    """The buffer holds ``n_rounds`` cumulative budgets after the empty one,
    each extending the one before without duplicates, and each budget's
    subset pkl holds exactly the buffer's frames. Returns (last budget key,
    its frames, the subset infos)."""
    from dal3d_tpu_torch.utils.fileio import load

    buf = load(buffer_file)
    keys = sorted(buf, key=int)
    origin = load(info_path)
    if len(keys) != n_rounds + 1 or keys[0] != "0" or buf["0"]:
        fail(f"{tag}: buffer keys {keys}, expected the empty round and {n_rounds} budgets")
    for prev, key in zip(keys[1:], keys[2:]):
        if not set(buf[prev]) < set(buf[key]):
            fail(f"{tag}: budget {key} does not extend budget {prev}")
    last = keys[-1]
    if not buf[last] or len(set(buf[last])) != len(buf[last]):
        fail(f"{tag}: budget {last} holds {buf[last]}")
    subset = load(info_path.replace(".pkl", f"_{last}.pkl"))
    if [i["token"] for i in subset] != [origin[i]["token"] for i in buf[last]]:
        fail(f"{tag}: the subset infos of budget {last} do not match the buffer")
    return last, buf[last], subset


def match_loop_dets(card: dict, plain: dict) -> tuple:
    """Pairs each frame's valid detections of two runs one to one: greedy by
    the card's score, the same label and the nearest centre within 0.1 m.
    Returns (matched, card total, plain total, largest box gap (max |diff|
    over the 9 values), largest centre gap, largest score gap)."""
    matched = n_card = n_plain = 0
    box_gap = ctr_gap = score_gap = 0.0
    for token, a in card.items():
        b = plain[token]
        va, vb = a["det_valid"].astype(bool), b["det_valid"].astype(bool)
        ba, bb = a["box3d_lidar"][va].astype(np.float64), b["box3d_lidar"][vb].astype(np.float64)
        sa, sb = a["scores"][va], b["scores"][vb]
        la, lb = a["label_preds"][va], b["label_preds"][vb]
        n_card, n_plain = n_card + len(sa), n_plain + len(sb)
        used = np.zeros(len(sb), bool)
        for k in np.argsort(-sa, kind="stable"):
            d = np.hypot(bb[:, 0] - ba[k, 0], bb[:, 1] - ba[k, 1])
            d[used | (lb != la[k]) | (d >= 0.1)] = np.inf
            if not len(d) or not np.isfinite(d.min()):
                continue
            j = int(d.argmin())
            used[j] = True
            matched += 1
            box_gap = max(box_gap, float(np.abs(bb[j] - ba[k]).max()))
            ctr_gap = max(ctr_gap, float(d[j]))
            score_gap = max(score_gap, abs(float(sb[j]) - float(sa[k])))
    return matched, n_card, n_plain, box_gap, ctr_gap, score_gap


def al_loop(tmp: str, dev, counters) -> dict:
    """Phase 15: two AL rounds through the port's CLIs on the production
    config at full width. Returns the phase's launches of each kernel, and
    the set's and the round's files (for phase 16)."""
    import re

    from dal3d_tpu_torch.data import DataLoader
    from dal3d_tpu_torch.models.builder import build_detector
    from dal3d_tpu_torch.ops import banded as bd
    from dal3d_tpu_torch.ops import iou_matrix as tiou
    from dal3d_tpu_torch.ops import rotated_iou as tri
    from dal3d_tpu_torch.runtime import checkpoint as ckpt
    from dal3d_tpu_torch.runtime import evaluation as tev
    from dal3d_tpu_torch.runtime.steps import VOXEL_KEYS, make_predict_step
    from dal3d_tpu_torch.tools import active_select, create_data, dist_test, train
    from dal3d_tpu_torch.utils.config import Config
    from dal3d_tpu_torch.utils.fileio import load

    base = os.path.join(tmp, "al_loop")
    root = os.path.join(base, "data", "synthetic")
    buffer_file = os.path.join(base, "buffer.json")
    work = os.path.join(base, "work_round1")
    cfg_path = os.path.join(base, "loop.py")
    os.makedirs(base)
    write_loop_config(cfg_path, root, buffer_file, work)
    info_train = os.path.join(root, "infos_train_10sweeps_withvelo.pkl")
    dets_path = os.path.join(base, "dets.pkl")
    on_cpu = ["--cpu"] if dev.type == "cpu" else []
    seconds = {}

    def cli(tag, fn, argv, on_device=True):
        t0 = time.perf_counter()
        out = fn(argv + (on_cpu if on_device else []))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds[tag] = time.perf_counter() - t0
        return out

    for c in counters:
        c.launches = 0
    t_phase = time.perf_counter()
    with IouRecorder(tri) as rec:
        cli("create_data synthetic_data_prep", create_data.main,
            ["synthetic_data_prep", "--root_path", root, "--n_frames", str(LOOP_FRAMES),
             "--n_logs", "2", "--seed", "0"], on_device=False)
        cli("active_select (init)", active_select.main, [cfg_path])
        if load(buffer_file) != {"0": []}:
            fail(f"AL loop: the first selection run wrote {load(buffer_file)}")
        cli("active_select --force_random", active_select.main,
            [cfg_path, "--force_random", "--seed", "3407"])
        b1, picks1, sub1 = loop_round("round 1", buffer_file, info_train, 1)
        cli(f"create_data nuscenes_data_prep --suffix {b1}", create_data.main,
            ["nuscenes_data_prep", "--root_path", root, "--suffix", b1], on_device=False)
        db1 = os.path.join(root, f"dbinfos_train_10sweeps_withvelo_{b1}.pkl")
        dbinfos = load(db1)
        n_obj = sum(len(i["gt_names"]) for i in sub1)
        n_db = sum(len(v) for v in dbinfos.values())
        if n_db != n_obj or any(d["image_idx"] >= len(sub1) or
                                not d["path"].startswith(f"gt_database_10sweeps_withvelo_{b1}/")
                                for v in dbinfos.values() for d in v):
            fail(f"AL loop: the suffixed GT database holds {n_db} objects for the subset's "
                 f"{n_obj}, or objects of other frames")
        np.random.seed(LOOP_SEED)
        trainer = cli(f"train --budget {b1} (1 epoch + val)", train.main,
                      [cfg_path, "--budget", b1, "--work_dir", work, "--epochs", "1",
                       "--seed", "0"])
        steps = trainer.step
        del trainer
        with open(os.path.join(work, "train.log")) as f:
            log = f.read()
        val = re.findall(r"val epoch 1: (\{.*\})", log)
        if (f"training on {info_train.replace('.pkl', f'_{b1}.pkl')}" not in log
                or f"GT-AUG database {db1}" not in log or len(val) != 1
                or "mAP_bev" not in val[0] or steps < 1):
            fail(f"AL loop: training did not read the suffixed infos and database, or ran no "
                 f"val phase ({steps} steps; val lines {val})")
        np.random.seed(LOOP_SEED)
        result = cli("dist_test --checkpoint --out", dist_test.main,
                     [cfg_path, "--checkpoint", work, "--work_dir", work, "--out", dets_path])
        if "mAP_bev" not in result.get("kitti_style", {}):
            fail(f"AL loop: evaluation returned no metrics: {result}")
        cli("active_select --checkpoint (round 2)", active_select.main,
            [cfg_path, "--checkpoint", work, "--seed", "3407"])
        b2, picks2, _ = loop_round("round 2", buffer_file, info_train, 2)
    phase_s = time.perf_counter() - t_phase
    launches = {c.__name__: c.launches for c in counters}

    cfg = Config.fromfile(cfg_path)
    n_val = len(load(os.path.join(root, "infos_val_10sweeps_withvelo.pkl")))
    batches = 2 * -(-n_val // B) + -(-LOOP_FRAMES // B)  # val, dist_test, round-2 scoring
    want = {c.__name__: 0 for c in counters}
    want.update(banded_conv=K1_PER_PREDICT * batches + K1_PER_TRAIN_STEP * steps,
                iou_matrix=K2_PER_PREDICT * batches, banded_dw=K3_PER_TRAIN_STEP * steps,
                pairwise_l2=1)
    if launches != want:
        fail(f"AL loop launched {launches}; expected {want} ({batches} predict batches of "
             f"{B}, {steps} train steps, one L2 map)")
    print(f"AL loop through the CLIs (configs/_cbgs_base.py at full width, B={B}; "
          f"{LOOP_FRAMES} train + {n_val} val synthetic frames of 10 sweeps; budget "
          f"{LOOP_BUDGET} a round): {phase_s:.1f} s; "
          + "; ".join(f"{k} {v:.2f} s" for k, v in seconds.items()))
    print(f"  rounds: budget {b1} -> {len(picks1)} frames, budget {b2} -> {len(picks2)} frames "
          f"(cumulative); suffixed GT database {n_db} objects of the subset's {len(sub1)} frames; "
          f"training read the suffixed infos and database; launches {launches} (as expected: "
          f"{batches} predict batches, {steps} train steps, one L2 map)")
    lines = re.findall(r"Epoch \[1\]\[(\d+)\] lr: [0-9.]+, time: ([0-9.]+) \(([0-9.]+) data\)", log)
    if not lines:
        fail("AL loop: the train log has no iteration line")
    it = np.array([[float(x[1]), float(x[2])] for x in lines]) * 1e3
    print(f"  train CLI with GT-AUG on, {steps} steps, iteration as logged ("
          f"{int(cfg['log_config']['interval'])}-step averages): "
          f"{', '.join(f'{v:.0f}' for v in it[:, 0])} ms, of which data wait "
          f"{', '.join(f'{v:.0f}' for v in it[:, 1])} ms")
    print(f"  val in training: {val[0]}")
    print(f"  dist_test: {result}")

    # kitti_style_eval from the card's IoUs and from the CPU's, on the
    # dist_test detections and on the val set's gt boxes moved by 0-0.5 m
    # (a set that matches, whatever one epoch of training gives)
    with open(dets_path, "rb") as f:
        dets = pickle.load(f)
    dataset = tev.build_val_dataset(cfg)
    rng = np.random.RandomState(LOOP_SEED)
    near = {}
    for info in dataset.infos:
        n = len(info["gt_names"])
        box = info["gt_boxes"] + rng.uniform(0, 0.5, (n, 9)).astype(np.float32)
        near[info["token"]] = {
            "box3d_lidar": box, "scores": rng.uniform(0.1, 1, n).astype(np.float32),
            "label_preds": np.array([dataset.class_names.index(c) for c in info["gt_names"]]),
            "det_valid": np.ones(n, bool)}
    n_det = sum(int(d["det_valid"].sum()) for d in dets.values())
    report = []
    for tag, d in (("dist_test detections", dets), ("moved gt boxes", near)):
        with IouRecorder(tri) as rec2:
            t0 = time.perf_counter()
            ap_card = tev.kitti_style_eval(dataset, d, device=dev)
            eval_s = time.perf_counter() - t0
        rec.calls += rec2.calls
        ap_cpu = tev.kitti_style_eval(dataset, d, device="cpu")
        if ap_card != ap_cpu:
            fail(f"AL loop: kitti_style_eval of the {tag} from the card's IoUs {ap_card} != "
                 f"from the CPU's {ap_cpu}")
        report.append(f"{tag}: {eval_s:.3f} s, of which {len(rec2.calls)} IoU calls "
                      f"{rec2.seconds:.3f} s; mAP_bev {ap_card['mAP_bev']:.4f} mAP_3d "
                      f"{ap_card['mAP_3d']:.4f}")
    if not ap_card["mAP_bev"] > 0:
        fail(f"AL loop: kitti_style_eval of moved gt boxes gives {ap_card}")

    # every IoU call of the phase's evaluations on the card against the same
    # call on the CPU
    card_calls = [c for c in rec.calls if c[4] == dev.type]
    iou_err, pairs = 0.0, 0
    for name, a, b, out, _ in card_calls:
        iou_err = max(iou_err, float((getattr(tri, name)(a, b) - out).abs().max()))
        pairs += out.numel()
    if not pairs or not iou_err <= 1e-5:
        fail(f"AL loop: {len(card_calls)} eval IoU calls ({pairs} pairs), max |card - CPU| "
             f"{iou_err:.3e} > 1e-5")
    print(f"  dist_test: {n_det} valid detections over {len(dets)} frames; eval IoUs: "
          f"{len(card_calls)} calls on the card ({pairs} pairs), max |card - CPU| {iou_err:.2e} "
          f"(tol 1e-05); kitti_style_eval equal from card and CPU IoUs, "
          + "; ".join(report))

    # the eval's rate, and the dist_test detections against the same path on
    # plain versions (ROADMAP C, open check 1)
    bundle = build_detector(cfg, device=dev)
    ckpt.load_checkpoint(work, bundle.model)
    predict = make_predict_step(bundle)
    loader = DataLoader(dataset, B, shuffle=False, drop_last=False)
    np.random.seed(LOOP_SEED)
    t0 = time.perf_counter()
    again = tev.predict_dataset(predict, loader)
    rate = n_val / (time.perf_counter() - t0)
    host_s, dev_s, fetch_s = [], [], []
    np.random.seed(LOOP_SEED)
    t_wait = time.perf_counter()
    for batch in loader:
        t_a = time.perf_counter()
        out = predict({k: batch[k] for k in VOXEL_KEYS})
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t_b = time.perf_counter()
        for k in tev.DET_KEYS:
            out[k].cpu()
        t_wait_next = time.perf_counter()
        host_s.append(t_a - t_wait)
        dev_s.append(t_b - t_a)
        fetch_s.append(t_wait_next - t_b)
        t_wait = t_wait_next
    same = all(np.array_equal(d[k], again[tok][k]) for tok, d in dets.items()
               for k in tev.DET_KEYS)
    print(f"  eval predict: {n_val} frames at {rate:.2f} frames/s (one loader thread); split per "
          f"batch of {B}: host (loader wait) {np.median(host_s) * 1e3:.1f} ms, device "
          f"(synchronized) {np.median(dev_s) * 1e3:.1f} ms, fetch {np.median(fetch_s) * 1e3:.2f} "
          f"ms; the same predict again in this process is bit-equal to dist_test's: {same}")

    def on_plain():
        k1, k2 = bd.banded_conv, tiou.iou_matrix
        bd.banded_conv, tiou.iou_matrix = bd.banded_conv_plain, tiou.iou_matrix_plain
        try:
            np.random.seed(LOOP_SEED)
            return tev.predict_dataset(predict, loader)
        finally:
            bd.banded_conv, tiou.iou_matrix = k1, k2

    # at the config's score threshold (the dist_test detections), and at 0,
    # where every NMS survivor is kept whatever one epoch did to the scores
    plain = on_plain()
    bundle.test_cfg = dataclasses.replace(bundle.test_cfg, score_threshold=0.0)
    np.random.seed(LOOP_SEED)
    card0 = tev.predict_dataset(predict, loader)
    for tag, card, ref in (("dist_test detections (score threshold "
                            f"{cfg['test_cfg']['score_threshold']})", dets, plain),
                           ("the same at score threshold 0", card0, on_plain())):
        matched, n_card, n_plain, box_gap, ctr_gap, score_gap = match_loop_dets(card, ref)
        if matched and not score_gap <= 0.02:
            fail(f"AL loop: {tag} vs plain versions: matched pairs' score gap {score_gap:.3e} "
                 f"> 0.02")
        scores = np.concatenate([d["scores"][d["det_valid"].astype(bool)] for d in card.values()])
        print(f"  {tag} on the trained checkpoint vs the same path on plain versions: matched "
              f"{matched} of {n_card} (plain {n_plain}; same label, centre within 0.1 m), match "
              f"rate {matched / max(n_card, n_plain, 1):.4f}; matched pairs' largest gaps: box "
              f"{box_gap:.3e}, centre {ctr_gap:.3e} m, score {score_gap:.3e} (tol 0.02); scores "
              + (f"{scores.min():.4g}-{scores.max():.4g}" if len(scores) else "none"))
    # the maps of the trained checkpoint on the first val batch (gated at 5e-2
    # of scale, as phase 5 holds the random weights)
    bundle.test_cfg = dataclasses.replace(bundle.test_cfg, score_threshold=0.1)
    np.random.seed(LOOP_SEED)
    batch = next(iter(loader))
    batch = {k: torch.as_tensor(batch[k]) for k in VOXEL_KEYS}
    with torch.inference_mode():
        heads = bundle.model(*(batch[k].to(dev) for k in VOXEL_KEYS))["preds"]
    top = max(float(torch.sigmoid(h["cls_preds"].float()).max()) for h in heads)
    finite = all(bool(torch.isfinite(h["box_preds"]).all()) for h in heads)
    print(f"  trained checkpoint, first val batch: "
          f"{plain_reference_check(bd, tiou, bundle, predict, batch, predict(batch))}; largest "
          f"class score {top:.4g}, box maps finite: {finite}")
    return launches, dict(root=root, cfg_path=cfg_path, work=work, buffer_file=buffer_file,
                          info_train=info_train, budget=b1,
                          info_val=os.path.join(root, "infos_val_10sweeps_withvelo.pkl"))



# ---------------------------------------------------------------------------
# raw points: the device voxelizer, predicts fed points, the PPAL / CALD
# pre-pass CLIs, --torch_init, the overfit twin
# ---------------------------------------------------------------------------

RAW_P = 300_000  # the configs' max_points: the loaders pad every cloud to it
# valid detections each plain prediction list of the overfit twin's scene must
# hold on the card and on the CPU (the scene has 2 + 3 cars; the twin finds 5)
TWIN_MIN_DETS = 4


def padded_points(clouds) -> tuple:
    """[B, RAW_P, 5] f32 points and [B, RAW_P] validity on the host, as the
    loaders' ReformatFixedShape pads them."""
    pts = torch.zeros(len(clouds), RAW_P, 5)
    valid = torch.zeros(len(clouds), RAW_P, dtype=torch.bool)
    for b, p in enumerate(clouds):
        n = min(len(p), RAW_P)
        pts[b, :n] = torch.from_numpy(p[:n])
        valid[b, :n] = True
    return pts, valid


def voxelizer_bound_ms(pts, M: int) -> float:
    """The bytes the voxelizer must move: the points and validity read once,
    features [B, M, F] f32, coordinates [B, M, 3] and counts [B, M] int32 and
    validity [B, M] written once, over the HBM rate."""
    Bp, P, F = pts.shape
    nbytes = Bp * P * (F * 4 + 1) + Bp * M * (F * 4 + 3 * 4 + 4 + 1)
    return nbytes / PEAK_BYTES * 1e3


def voxelizer_check(tag: str, cfg, clouds, dev) -> dict:
    """Both device voxelizers on the card against the same functions on the
    CPU (integer outputs bit-equal, features within 1e-6 of scale), a repeat
    on the card, device ms against the host voxelizer's ms for the batch and
    the bytes bound."""
    from dal3d_tpu_torch.core.voxel_generator import points_to_voxel_mean
    from dal3d_tpu_torch.ops.voxelize import VoxelConfig, voxelize_mean, voxelize_mean_grid

    vg = cfg["voxel_generator"]
    vcfg = VoxelConfig(tuple(vg["range"]), tuple(vg["voxel_size"]),
                       int(vg["max_points_in_voxel"]), int(vg["max_voxel_num"]))
    pts, valid = padded_points(clouds)
    gp, gv = pts.to(dev), valid.to(dev)
    res = {}
    for fn in (voxelize_mean_grid, voxelize_mean):
        cpu = fn(pts, valid, vcfg)
        card, again = fn(gp, gv, vcfg), fn(gp, gv, vcfg)
        for k in ("coordinates", "num_points", "voxel_valid", "num_voxels"):
            if not torch.equal(card[k].cpu(), cpu[k]):
                fail(f"{tag} {fn.__name__}: {k} on the card differs from the CPU's")
        scale = max(float(cpu["features"].abs().max()), 1e-30)
        err = float((card["features"].cpu() - cpu["features"]).abs().max()) / scale
        if not err <= 1e-6:
            fail(f"{tag} {fn.__name__}: features on the card {err:.2e} of scale from the CPU's "
                 "(tol 1e-6)")
        repeat = all(torch.equal(card[k], again[k]) for k in card)
        ms = cuda_time_ms(lambda: fn(gp, gv, vcfg), 10)
        res[fn.__name__] = dict(ms=ms, err=err, repeat=repeat,
                                voxels=[int(x) for x in card["num_voxels"]])
    t0 = time.perf_counter()
    for p in clouds:
        points_to_voxel_mean(p[:RAW_P], vg["voxel_size"], vg["range"],
                             int(vg["max_points_in_voxel"]), vcfg.max_voxel_num)
    host_ms = (time.perf_counter() - t0) * 1e3
    bound = voxelizer_bound_ms(pts, vcfg.max_voxel_num)
    g, m = res["voxelize_mean_grid"], res["voxelize_mean"]
    print(f"device voxelizer, {tag} (B={B}, {[len(p) for p in clouds]} points padded to {RAW_P}, "
          f"grid {vcfg.grid_size}, max {vcfg.max_voxel_num} voxels): voxelize_mean_grid (the "
          f"models' path) {g['ms']:.3f} ms on the card, voxels {g['voxels']}, features "
          f"{g['err']:.1e} of scale from the CPU's (tol 1e-06), coordinates / counts / validity "
          f"/ order bit-equal, a repeat on the card bit-equal: {g['repeat']}; voxelize_mean "
          f"(first arrivals) {m['ms']:.3f} ms, features {m['err']:.1e}, repeat bit-equal "
          f"{m['repeat']}; bound {bound:.4f} ms (bytes); host voxelizer "
          f"(core/voxel_generator.py) {host_ms:.1f} ms for the batch")
    return dict(grid_ms=g["ms"], sort_ms=m["ms"], host_ms=host_ms, bound_ms=bound,
                repeat=g["repeat"], voxels=g["voxels"])


def timed_predicts(predict, batch) -> tuple:
    """A warm-up and TIMED_ITERS synchronized predicts: (last output, ms)."""
    out = predict(batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_ITERS):
        t0 = time.perf_counter()
        out = predict(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, times


def raw_predicts(cfgs, counters, host_fed_ms, bd, tiou, tg) -> dict:
    """The CBGS and BEVFusion predicts fed raw points (B=2, the clouds of
    phases 5 and 14), each with its launch counts, median, device profile and
    plain check, beside the host-fed medians. Returns the launches."""
    from dal3d_tpu_torch.models.builder import build_bevfusion, build_detector
    from dal3d_tpu_torch.runtime.bevfusion_steps import make_bevfusion_predict_step
    from dal3d_tpu_torch.runtime.steps import make_predict_step

    cbgs = build_detector(cfgs["cbgs"], seed=0)
    bev = build_bevfusion(cfgs["bevfusion"], seed=0)
    runs = (("CBGS", cbgs, make_predict_step(cbgs), cbgs_clouds(0),
             dict(banded_conv=K1_PER_PREDICT, iou_matrix=K2_PER_PREDICT)),
            ("BEVFusion", bev, make_bevfusion_predict_step(bev), bevfusion_clouds(10),
             dict(gather_gemm=K4_PER_PREDICT, gather_rows=K5_PER_PREDICT)))
    total = {c.__name__: 0 for c in counters}
    for tag, bundle, predict, clouds, per in runs:
        pts, valid = padded_points(clouds)
        batch = {"points": pts, "points_valid": valid}
        for c in counters:
            c.launches = 0
        torch.cuda.reset_peak_memory_stats()
        out, times = timed_predicts(predict, batch)
        launches = {c.__name__: c.launches for c in counters}
        want = {n: per.get(n, 0) * (TIMED_ITERS + 1) for n in launches}
        if launches != want:
            fail(f"{tag} predict from raw points launched {launches}; expected {want}")
        for k, v in out.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                fail(f"{tag} predict from raw points: output {k} is not finite")
        n_det = [int(x) for x in out["det_valid"].sum(1)]
        if min(n_det) == 0:
            fail(f"{tag} predict from raw points: no detections {n_det}")
        med = float(np.median(times))
        print(f"{tag} predict from raw points (B={B}, device voxelizer): median {med:.2f} ms "
              f"(host-fed, phase {5 if tag == 'CBGS' else 14}: {host_fed_ms[tag]:.2f} ms, the "
              f"host voxelizer not counted), min {min(times):.2f} ms -> {B / med * 1e3:.2f} "
              f"scans/s; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
              f"detections {n_det}; launches {launches} in {TIMED_ITERS + 1} predicts")
        if tag == "CBGS":
            check = plain_reference_check(bd, tiou, bundle, predict, batch, out)
        else:
            check = bevfusion_plain_check(bundle, batch, tg)
        print(f"  {tag} from raw points vs the same path on plain versions: {check}")
        device_profile(lambda: predict(batch), f"{tag} raw predict", med)
        for n, v in launches.items():
            total[n] += v
        del bundle, predict
        torch.cuda.empty_cache()
    return total


def prepass_selector(selector: str, info: str, buffer_file: str, base: str) -> dict:
    """The PPAL or CALD selector of configs/cbgs_ppal.py / cbgs_cald.py over
    the pool ``info``, its files under ``base``."""
    sel = {"PPALSelector": dict(type="PPALSelector", delta=1.5,
                                diff_file=os.path.join(base, "diff_category_average.json"),
                                pred_store_file=os.path.join(base, "ppal_pred.npz")),
           "CaldSelector": dict(type="CaldSelector",
                                sorted_idx_file=os.path.join(base, "cald_ent_sorted_idx.json"),
                                jsdiv_file=os.path.join(base, "idx_to_jsdiv.pkl"))}[selector]
    sel.update(budget=LOOP_BUDGET, buffer_file=buffer_file, infos_origin=info)
    return sel


def loop_prepass_config(loop: dict):
    """The writer of the pre-pass configs on phase 15's set: the AL loop's
    production config with the selector and the score threshold at 0 (after
    one epoch from random weights no box clears the config's 0.1, and the
    pre-passes need detections)."""
    def write(path: str, sel: dict) -> None:
        write_loop_config(path, loop["root"], sel["buffer_file"], loop["work"],
                          extra=(f"selector = {sel!r}\ntest_cfg = copy.deepcopy(test_cfg)\n"
                                 "test_cfg['score_threshold'] = 0.0\n"))

    return write


def prepass_round(tag: str, base: str, write_cfg, work: str, info: str, buffer0: dict,
                  on_cpu: bool, seconds: dict) -> dict:
    """One PPAL round and one CALD round through the port's CLIs over the
    pool ``info`` with the checkpoint in ``work``, each from the buffer
    ``buffer0``: ppal_pred_list, ppal_unc, active_select (PPALSelector);
    cald_pred_list plain and --augment, cald_ent, active_select
    (CaldSelector). ``write_cfg(path, selector)`` writes each config.
    Returns the files' contents."""
    from dal3d_tpu_torch.tools import (active_select, cald_ent, cald_pred_list,
                                       ppal_pred_list, ppal_unc)
    from dal3d_tpu_torch.utils.fileio import dump, load

    os.makedirs(base)
    flag = ["--cpu"] if on_cpu else []
    out = {}
    labeled = buffer0[max(buffer0, key=int)]

    def cli(name, fn, argv):
        np.random.seed(LOOP_SEED)  # a frame's sweep draw uses numpy's global generator
        t0 = time.perf_counter()
        r = fn(argv + flag)
        if not on_cpu:
            torch.cuda.synchronize()
        seconds[f"{tag} {name}"] = time.perf_counter() - t0
        return r

    cwd = os.getcwd()
    os.chdir(base)  # ppal_unc writes dict_p_iou.pkl to the working directory
    try:
        for selector in ("PPALSelector", "CaldSelector"):
            buffer_file = os.path.join(base, f"{selector}.json")
            dump(buffer0, buffer_file)
            cfg = os.path.join(base, f"{selector}.py")
            write_cfg(cfg, prepass_selector(selector, info, buffer_file, base))
            if selector == "PPALSelector":
                pl = os.path.join(base, "pred_list.pkl")
                out["pred_list"] = cli("ppal_pred_list", ppal_pred_list.main,
                                       [cfg, "--checkpoint", work, "--out", pl])
                out["weights"] = cli("ppal_unc", ppal_unc.main,
                                     [cfg, "--pred_list", pl,
                                      "--out", os.path.join(base, "diff_category_average.json")])
                cli("active_select (PPAL)", active_select.main,
                    [cfg, "--checkpoint", work, "--seed", "3407"])
            else:
                plain, aug = (os.path.join(base, n) for n in ("plain.pkl", "aug.pkl"))
                out["cald_plain"] = cli("cald_pred_list", cald_pred_list.main,
                                        [cfg, "--checkpoint", work, "--out", plain])
                out["cald_aug"] = cli("cald_pred_list --augment", cald_pred_list.main,
                                      [cfg, "--checkpoint", work, "--out", aug,
                                       "--augment"])
                out["order"], out["jsdiv"] = cli(
                    "cald_ent", cald_ent.main,
                    [cfg, "--pred_list", plain, "--pred_list_aug", aug,
                     "--sorted_out", os.path.join(base, "cald_ent_sorted_idx.json"),
                     "--jsdiv_out", os.path.join(base, "idx_to_jsdiv.pkl")])
                cli("active_select (CALD)", active_select.main, [cfg, "--seed", "3407"])
            out[selector] = open(buffer_file, "rb").read()
            buf = load(buffer_file)
            new = buf[max(buf, key=int)]
            if (len(buf) != len(buffer0) + 1 or not set(labeled) < set(new)
                    or len(set(new)) != len(new)):
                fail(f"{tag} {selector} round: buffer {buf} does not extend {labeled}")
    finally:
        os.chdir(cwd)
    tokens = [i["token"] for i in load(info)]
    for k in ("pred_list", "cald_plain", "cald_aug"):
        if list(out[k]) != tokens:
            fail(f"{tag} {k}: tokens {list(out[k])[:3]}... are not the pool's")
    if sorted(out["order"]) != list(range(len(tokens))) or sorted(out["jsdiv"]) != sorted(
            range(len(tokens))):
        fail(f"{tag} cald_ent: ranking {out['order']} / JS divergences of {sorted(out['jsdiv'])}")
    return out


def prepass_phase(tmp: str, dev, loop: dict, counters) -> dict:
    """The PPAL and CALD rounds through the CLIs on phase 15's synthetic
    set and trained checkpoint, on the card over the whole pool. Returns
    the round's launches."""
    from dal3d_tpu_torch.utils.fileio import load

    base = os.path.join(tmp, "prepass")
    pool = load(loop["info_train"])
    # from phase 15's first round: its second left no frame of the pool out
    buffer0 = {"0": [], loop["budget"]: load(loop["buffer_file"])[loop["budget"]]}
    labeled = buffer0[loop["budget"]]
    seconds = {}
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    card = prepass_round("card", os.path.join(base, "card"), loop_prepass_config(loop),
                         loop["work"], loop["info_train"], buffer0, False, seconds)
    phase_s = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    n = len(pool)
    batches = 4 * -(-n // B)  # three prediction lists and PPAL's pool scoring
    want = {c.__name__: 0 for c in counters}
    want.update(banded_conv=K1_PER_PREDICT * batches, iou_matrix=K2_PER_PREDICT * batches,
                pairwise_l1=1)  # cbgs_ppal.py's k-center: distance_type l2_ref is L1
    if launches != want:
        fail(f"PPAL / CALD round launched {launches}; expected {want} ({batches} predict "
             f"batches of {B}, one L1 map)")
    n_det = sum(int(d["det_valid"].sum()) for d in card["pred_list"].values())
    n_aug = sum(int(d["det_valid"].sum()) for d in card["cald_aug"].values())
    print(f"PPAL / CALD rounds through the CLIs (phase 15's checkpoint and {n}-frame pool, "
          f"labeled {len(labeled)}, budget {LOOP_BUDGET}, score threshold 0): {phase_s:.1f} s; "
          + "; ".join(f"{k} {v:.2f} s" for k, v in seconds.items()))
    print(f"  launches {launches} (as expected: {batches} predict batches, one L1 map); "
          f"detections {n_det} plain, {n_aug} flipped; PPAL weights {card['weights']}; CALD "
          f"ranking {card['order']}")

    return launches


def match_sets(card: dict, cpu: dict) -> tuple:
    """Pairs each frame's valid detections of two prediction lists one to
    one: greedy by the card's score, the same label and the nearest box (the
    largest |difference| over its 9 values, relative to max(1, |value|)).
    Returns (pairs within 1e-3, card total, CPU total, the largest box and
    score gaps of those pairs, the unpaired detections as (side, token,
    score, label, box))."""
    matched = n_a = n_b = 0
    box_gap = score_gap = 0.0
    unpaired = []
    for token, a in card.items():
        b = cpu[token]
        va, vb = a["det_valid"].astype(bool), b["det_valid"].astype(bool)
        ba, bb = a["box3d_lidar"][va].astype(np.float64), b["box3d_lidar"][vb].astype(np.float64)
        sa, sb = a["scores"][va], b["scores"][vb]
        la, lb = a["label_preds"][va], b["label_preds"][vb]
        n_a, n_b = n_a + len(sa), n_b + len(sb)
        used = np.zeros(len(sb), bool)
        for k in np.argsort(-sa, kind="stable"):
            d = (np.abs(bb - ba[k]) / np.maximum(np.abs(ba[k]), 1.0)).max(1) if len(bb) else bb
            d = np.where(used | (lb != la[k]), np.inf, d)
            if not len(d) or not d.min() <= 1e-3:
                unpaired.append(("card", token, float(sa[k]), int(la[k]), ba[k].tolist()))
                continue
            j = int(d.argmin())
            used[j] = True
            matched += 1
            box_gap = max(box_gap, float(d[j]))
            score_gap = max(score_gap, abs(float(sb[j]) - float(sa[k])))
        unpaired += [("cpu", token, float(sb[j]), int(lb[j]), bb[j].tolist())
                     for j in np.flatnonzero(~used)]
    return matched, n_a, n_b, box_gap, score_gap, unpaired


def twin_prepass_config(work: str):
    """The writer of the pre-pass configs on the overfit twin: its model,
    grid and test settings (score threshold 0.3) over the scene's pool
    (``tests/test_torch_accuracy.py::write_twin_config``)."""
    import test_torch_accuracy as acc

    def write(path: str, sel: dict) -> None:
        acc.write_twin_config(path, sel["infos_origin"], selector=sel, work_dir=work)

    return write


def prepass_card_vs_cpu(twin: dict) -> dict:
    """The pre-pass CLIs on the overfit twin's trained checkpoint and its
    2-frame scene (``overfit_phase``), nothing labeled, f32, on the card and
    with --cpu: their files compared, and each side's plain prediction
    lists holding at least TWIN_MIN_DETS valid detections, so that a run
    that detects nothing cannot pass. Returns the seconds of each CLI."""
    base = os.path.join(twin["root"], "prepass")
    write_cfg = twin_prepass_config(twin["work"])
    seconds = {}
    got = {side: prepass_round(side, os.path.join(base, side), write_cfg, twin["work"],
                               twin["info"], {"0": []}, side == "cpu", seconds)
           for side in ("card", "cpu")}
    a, b = got["card"], got["cpu"]
    report, bad, unpaired = [], [], {}
    for k in ("pred_list", "cald_plain", "cald_aug"):
        matched, n_a, n_b, box_gap, score_gap, unpaired[k] = match_sets(a[k], b[k])
        if matched != n_a or n_a != n_b or not score_gap <= 1e-4:
            bad.append(k)
        if k != "cald_aug" and not min(n_a, n_b) >= TWIN_MIN_DETS:
            bad.append(f"{k} holds {n_a} (card) and {n_b} (CPU) valid detections, fewer than "
                       f"{TWIN_MIN_DETS}")
        report.append(f"{k} {matched}/{n_a} matched (CPU {n_b}), box gap {box_gap:.1e}, score "
                      f"gap {score_gap:.1e}")
    w_gap = max((abs(a["weights"][c] - b["weights"][c]) for c in a["weights"]), default=0.0)
    js_gap = max(abs(a["jsdiv"][i] - b["jsdiv"][i]) for i in a["jsdiv"])
    if set(a["weights"]) != set(b["weights"]) or not w_gap <= 1e-4:
        bad.append("ppal_unc")
    if a["order"] != b["order"] or not js_gap <= 1e-4:
        bad.append("cald_ent")
    bad += [sel for sel in ("PPALSelector", "CaldSelector") if a[sel] != b[sel]]
    print(f"  the pre-pass CLIs on the overfit twin's checkpoint and 2-frame scene (nothing "
          f"labeled, f32, score threshold 0.3), card vs --cpu: {'; '.join(report)} (tol: every "
          f"detection paired within 1e-3 of max(1, |box|), scores within 1e-4, at least "
          f"{TWIN_MIN_DETS} valid detections in each plain list); PPAL weights "
          f"{a['weights']} within {w_gap:.1e}, CALD ranking {a['order']} / {b['order']}, JS "
          f"divergences within {js_gap:.1e} (tol 1e-4); buffers {a['PPALSelector']!r} / "
          f"{b['PPALSelector']!r}, {a['CaldSelector']!r} / {b['CaldSelector']!r}; "
          + "; ".join(f"{k} {v:.2f} s" for k, v in seconds.items()))
    for k in bad:
        if unpaired.get(k):
            print(f"  {k}, unpaired detections (side, token, score, label, box): "
                  + "; ".join(f"{u[0]} {u[1]} {u[2]:.3e} {u[3]} "
                              + "[" + ", ".join(f"{x:.3e}" for x in u[4]) + "]"
                              for u in unpaired[k][:12]))
    if bad:
        fail(f"pre-pass CLIs on the overfit twin, card vs CPU: {bad}")
    return seconds


def torch_init_phase(tmp: str, dev, loop: dict, counters) -> dict:
    """--torch_init at full width: a det3d-named .pth of seeded random
    weights (every tensor the loader maps on the production config) ->
    convert_second -> dist_test --torch_init and one train --torch_init epoch
    on the round-1 subset; the loaded model equals the written weights after
    the layout map. Returns the launches."""
    from dal3d_tpu_torch.models.builder import build_detector
    from dal3d_tpu_torch.models.convert_second import apply_torch_init, to_det3d_state_dict
    from dal3d_tpu_torch.tools import convert_second, dist_test, train
    from dal3d_tpu_torch.utils.config import Config
    from dal3d_tpu_torch.utils.fileio import load

    base = os.path.join(tmp, "torch_init")
    os.makedirs(base)
    cfg = Config.fromfile(loop["cfg_path"])
    src = build_detector(cfg, device="cpu", seed=21).model.state_dict()
    det3d = to_det3d_state_dict(src)
    pth, npz = os.path.join(base, "det3d.pth"), os.path.join(base, "det3d.npz")
    torch.save({"state_dict": {f"module.{k}": torch.from_numpy(v) for k, v in det3d.items()}},
               pth)
    seconds = {}
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    convert_second.main([pth, npz, "--config", loop["cfg_path"]])
    seconds["convert_second"] = time.perf_counter() - t0
    # the loaded model against the written tensors, each through the layout
    # map written out here: spconv [kd, kh, kw, Cin, Cout] -> [kd*kh*kw, Cin, Cout]
    model = build_detector(cfg, device=dev, seed=0).model
    apply_torch_init(model, npz)
    stem = det3d["backbone.middle_conv0.0.weight"]
    mapped = torch.from_numpy(stem.reshape(-1, *stem.shape[3:]))
    loaded = model.state_dict()
    same = all(torch.equal(loaded[k].cpu(), v) for k, v in src.items())
    if not same or not torch.equal(loaded["backbone.l0.stem.weight"].cpu(), mapped):
        fail("torch_init: the loaded model differs from the written det3d weights")
    np.random.seed(LOOP_SEED)
    t0 = time.perf_counter()
    work = os.path.join(base, "work")
    result = dist_test.main([loop["cfg_path"], "--torch_init", npz, "--work_dir", work,
                             "--out", os.path.join(base, "dets.pkl")])
    torch.cuda.synchronize()
    seconds["dist_test --torch_init"] = time.perf_counter() - t0
    np.random.seed(LOOP_SEED)
    t0 = time.perf_counter()
    tr = train.main([loop["cfg_path"], "--budget", loop["budget"], "--work_dir", work,
                     "--epochs", "1", "--no_validate", "--seed", "0", "--torch_init", npz])
    torch.cuda.synchronize()
    seconds["train --torch_init --epochs 1"] = time.perf_counter() - t0
    steps = tr.step
    del tr
    launches = {c.__name__: c.launches for c in counters}
    n_val = len(load(loop["info_val"]))
    batches = -(-n_val // B)
    want = {c.__name__: 0 for c in counters}
    want.update(banded_conv=K1_PER_PREDICT * batches + K1_PER_TRAIN_STEP * steps,
                iou_matrix=K2_PER_PREDICT * batches, banded_dw=K3_PER_TRAIN_STEP * steps)
    if steps < 1 or launches != want or "mAP_bev" not in result.get("kitti_style", {}):
        fail(f"torch_init: {steps} train steps, launched {launches}, expected {want}; dist_test "
             f"gave {result}")
    with open(os.path.join(work, "test.log")) as f:
        if f"initialized from converted torch checkpoint {npz}" not in f.read():
            fail("torch_init: dist_test did not load the converted checkpoint")
    with open(os.path.join(work, "train.log")) as f:
        if f"warm-started from converted torch checkpoint {npz}" not in f.read():
            fail("torch_init: train did not load the converted checkpoint")
    print(f"--torch_init at full width ({len(det3d)} det3d tensors of the production config, "
          f"seeded): the loaded model equals the written weights after the layout map; "
          f"dist_test {result.get('kitti_style')}; train {steps} steps on budget "
          f"{loop['budget']}; launches {launches} (as expected); "
          + "; ".join(f"{k} {v:.2f} s" for k, v in seconds.items()))
    return launches


TWIN_TIMEOUT = 900  # seconds the main process waits for the twin's training


def twin_worker(path: str) -> None:
    """The overfit twin's training (``tests/test_torch_accuracy.py::overfit``)
    on the card in a process of its own: its trained state, last logs,
    kitti results, predict output, seconds and launches saved to ``path``.
    It is host-bound (a tiny model), so it runs beside the main process's
    phases 15-16 instead of after them."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    torch.set_num_threads(2)
    import test_torch_accuracy as acc

    from dal3d_tpu_torch.ops import banded as bd
    from dal3d_tpu_torch.ops import distance as td
    from dal3d_tpu_torch.ops import gather as tg
    from dal3d_tpu_torch.ops import iou_matrix as tiou
    from dal3d_tpu_torch.ops import lsa as tl

    counters = (bd.banded_conv, bd.banded_dw, tiou.iou_matrix, td.pairwise_l1,
                td.pairwise_l2, tg.gather_gemm, tg.gather_rows, tg.gather_dw,
                tl.linear_sum_assignment, tg.gather_gemm_bf16, tg.gather_dw_bf16)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    logs, bundle, _, out, res = acc.overfit("cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    torch.save(dict(logs=logs, out=out, res=res, seconds=seconds,
                    launches={c.__name__: c.launches for c in counters},
                    state={k: v.cpu() for k, v in bundle.model.state_dict().items()}), path)


def start_twin(tmp: str):
    """Start ``twin_worker`` (spawned, daemonic: it ends with this process);
    ``overfit_phase`` joins it."""
    import multiprocessing

    path = os.path.join(tmp, "twin_trained.pt")
    proc = multiprocessing.get_context("spawn").Process(target=twin_worker, args=(path,),
                                                        daemon=True)
    proc.start()
    return proc, path


def overfit_phase(tmp: str, bd, tiou, counters, twin_proc) -> tuple:
    """tests/test_torch_accuracy.py's scene on the card: STEPS train steps
    from raw points (``twin_worker``, started by ``start_twin``; joined here),
    the mAP gates, and the detections against the same weights on the plain
    versions; then the trained checkpoint and the scene as a 2-frame pool
    for the pre-pass CLIs. Returns (the twin's launches, its training's
    seconds, the seconds this process waited for it, the twin: bundle,
    batch, root, work, info)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_accuracy as acc

    from dal3d_tpu_torch.runtime.checkpoint import save_checkpoint

    proc, path = twin_proc
    t0 = time.perf_counter()
    proc.join(TWIN_TIMEOUT)
    wait_s = time.perf_counter() - t0
    if proc.is_alive():
        proc.kill()
        fail(f"the overfit twin's training outlived {TWIN_TIMEOUT} s")
    if proc.exitcode != 0 or not os.path.isfile(path):
        fail(f"the overfit twin's training process exited with {proc.exitcode}")
    got = torch.load(path, weights_only=False)
    logs, out, res, phase_s, launches = (got[k] for k in ("logs", "out", "res", "seconds",
                                                          "launches"))
    bundle = acc.make_bundle("cuda")
    bundle.model.load_state_dict(got["state"])
    _, batch = acc.scene_batch()
    if not (logs["loss"] < 0.05 and res["mAP_bev"] >= 0.5 and res["mAP_3d"] >= 0.3):
        fail(f"overfit twin: loss {logs['loss']:.4f} (< 0.05), {res} (mAP_bev >= 0.5, "
             "mAP_3d >= 0.3)")
    from dal3d_tpu_torch.runtime.steps import make_predict_step

    k1, k2 = bd.banded_conv, tiou.iou_matrix
    bd.banded_conv, tiou.iou_matrix = bd.banded_conv_plain, tiou.iou_matrix_plain
    try:
        ref = make_predict_step(bundle)({"points": batch["points"],
                                         "points_valid": batch["points_valid"]})
        ref = {k: v.cpu().numpy() for k, v in ref.items()}
    finally:
        bd.banded_conv, tiou.iou_matrix = k1, k2
    def to_frames(o):
        return {str(b): {k: o[k][b] for k in ("box3d_lidar", "scores", "label_preds",
                                              "det_valid")} for b in range(B)}

    matched, n_card, n_plain, box_gap, ctr_gap, score_gap = match_loop_dets(to_frames(out),
                                                                            to_frames(ref))
    if not matched or not score_gap <= 0.02:
        fail(f"overfit twin vs plain versions: matched {matched} of {n_card}, score gap "
             f"{score_gap:.3e}")
    print(f"overfit twin (tests/test_torch_accuracy.py's scene, {acc.STEPS} steps from raw "
          f"points on the card, in a process of its own beside phases 15-16): {phase_s:.1f} s, "
          f"of which this process waited {wait_s:.1f} s; loss {logs['loss']:.4f}; kitti AP40 "
          f"{res}; "
          f"detections vs the same weights on plain versions: matched {matched} of {n_card} "
          f"(plain {n_plain}), match rate {matched / max(n_card, n_plain, 1):.4f}, gaps box "
          f"{box_gap:.2e} centre {ctr_gap:.2e} m score {score_gap:.2e} (tol 0.02); launches "
          f"{launches}")
    root = os.path.join(tmp, "twin")
    twin = dict(bundle=bundle, batch=batch, root=root, work=os.path.join(root, "work"),
                info=acc.write_scene_pool(root))
    save_checkpoint(twin["work"], bundle.model, epoch=1)
    return launches, phase_s, wait_s, twin


def raw_points_phase(tmp: str, dev, Config, counters, host_fed_ms, loop, bd, tiou, tg,
                     twin_proc) -> dict:
    """Phase 16. Returns each kernel's launches over the phase."""
    t_phase = time.perf_counter()
    cfgs = {k: Config.fromfile(os.path.join(ROOT, "configs", f)) for k, f in
            (("cbgs", "cbgs_spatial_temporal.py"), ("bevfusion", "bevfusion_lidar.py"))}
    vox = {"cbgs": voxelizer_check("CBGS (configs/cbgs_spatial_temporal.py, phase 5's clouds)",
                                   cfgs["cbgs"], cbgs_clouds(0), dev),
           "bevfusion": voxelizer_check("BEVFusion (configs/bevfusion_lidar.py, phase 14's "
                                        "clouds)", cfgs["bevfusion"], bevfusion_clouds(10), dev)}
    parts = [raw_predicts(cfgs, counters, host_fed_ms, bd, tiou, tg),
             prepass_phase(tmp, dev, loop, counters),
             torch_init_phase(tmp, dev, loop, counters)]
    over, over_s, wait_s, twin = overfit_phase(tmp, bd, tiou, counters, twin_proc)
    parts.append(over)
    total = {c.__name__: sum(p[c.__name__] for p in parts) for c in counters}
    t0 = time.perf_counter()
    prepass_card_vs_cpu(twin)
    twin_s = time.perf_counter() - t0
    phase_s = time.perf_counter() - t_phase
    print(f"phase 16 (raw points): {phase_s:.1f} s, of which {wait_s:.1f} s waiting for the "
          f"overfit twin's training ({over_s:.1f} s beside phases 15-16); launches {total} (the "
          f"twin's counted in its process); the card-vs-CPU pre-pass check on the overfit twin "
          f"took {twin_s:.1f} s")
    return dict(launches=total, voxelizer=vox, overfit_s=over_s, twin=twin)


# ---------------------------------------------------------------------------
# the partial-label round: ActiveTrainer (detector + estimator), selection
# that excludes the seed set, the next round on the picks
# ---------------------------------------------------------------------------
# of phase 15's 16 frames: the config's 0.1 of a 28130-frame pool would seed
# one frame here
PARTIAL_RATIO = 0.25
HEAD_MAP_TOL = 1e-5  # f32 head maps on K1 vs its plain version, of each map's scale
EST_MAX_PTS, EST_HIDDEN = 128, (64, 128)  # configs/cbgs_partial.py's Estimator


def write_partial_config(path: str, loop: dict, base: str, work_dir: str,
                         extra: str = "") -> None:
    """configs/cbgs_partial.py (the production CBGS model at full width, its
    GT-AUG sampler, the partial-label dataset, the Estimator) pointed at
    phase 15's synthetic set the way write_loop_config points the base, its
    seed buffer and its selection files under ``base``, and the score
    threshold at 0: after one epoch from random weights no box clears the
    config's 0.1, and an empty ``det_valid`` leaves every estimator gradient
    zero."""
    root = loop["root"]
    info = os.path.join(root, "infos_{}_10sweeps_withvelo.pkl")
    sel = dict(type="EntropySelector", budget=LOOP_BUDGET,
               buffer_file=os.path.join(base, "partial.json"),
               infos_origin=info.format("train"),
               pred_store_file=os.path.join(base, "partial_pred.npz"),
               exclude_buffer=os.path.join(base, "partial_buffer.json"))
    with open(path, "w") as f:
        f.write(f"import copy, sys\nsys.path.insert(0, {os.path.join(ROOT, 'configs')!r})\n"
                "from cbgs_partial import *  # noqa: F401,F403\n"
                "data = copy.deepcopy(data)\n"
                f"data['train'].update(root_path={root!r}, info_path={info.format('train')!r})\n"
                f"data['val'].update(root_path={root!r}, info_path={info.format('val')!r})\n"
                "data['train']['pipeline'][2]['cfg']['db_sampler']['db_info_path'] = "
                f"{os.path.join(root, 'dbinfos_train_10sweeps_withvelo.pkl')!r}\n"
                f"work_dir = {work_dir!r}\n"
                f"active_buffer = {sel['exclude_buffer']!r}\n"
                f"sample_ratio = {PARTIAL_RATIO!r}\n"
                f"selector = {sel!r}\n"
                "test_cfg = copy.deepcopy(test_cfg)\ntest_cfg['score_threshold'] = 0.0\n"
                + extra)


def partial_dataset(cfg):
    """The train set the CLI builds for a partial-label config."""
    from dal3d_tpu_torch.data.datasets.nuscenes_partial import NuScenesPartialDataset
    from dal3d_tpu_torch.models.builder import loader_voxelize_cfg

    td = {k: v for k, v in dict(cfg["data"]["train"]).items() if k != "type"}
    knobs = {k: cfg[k] for k in ("active_buffer", "active_flag", "sample_ratio",
                                 "label_fraction") if cfg.get(k) is not None}
    return NuScenesPartialDataset(**{**td, **knobs, "tasks": [dict(t) for t in cfg["tasks"]],
                                     "pipeline": [dict(s) for s in td["pipeline"]],
                                     "max_points": cfg.get("max_points", 300000),
                                     "voxelize_host": loader_voxelize_cfg(cfg)})


def estimator_card_vs_plain(bundle, estimator, batch, bd, tiou, hold_plain: bool = False) -> str:
    """One estimator step's inputs and loss from a trained f32 detector
    (``bundle``, on the card), with the kernels and with each kernel swapped
    for its plain version, held kernel by kernel:

    - K1: the predict's head maps against those of K1's plain version,
      within HEAD_MAP_TOL of each map's scale;
    - K2: on K1's head maps, the step with K2 and with its plain version:
      as many valid slots; the valid detections paired by score and box
      (candidates of equal score come out of the top-k in an order of its
      own, so a slot may hold another box), and on every pair the pool
      indices equal and the targets within 1e-5; the loss over all slots
      within 1e-5.

    The step with both plain versions is reported beside it, and held to
    the slot only with ``hold_plain`` (the overfit twin, whose boxes hold
    points and whose scores separate): phase 15's briefly trained detector
    decodes hundreds of boxes of infinite or astronomic size (``exp`` of its
    box maps), and a gap of 1e-6 of scale in the maps flips NMS decisions
    among them (82 against 84 valid slots seen on one checkpoint)."""
    import copy

    from dal3d_tpu_torch.models.detectors import estimator as te
    from dal3d_tpu_torch.runtime import active_trainer as ta

    bundle.model.train()
    predict = ta.multi_group_predict

    def step(maps=None):
        """The step; with ``maps`` the predict decodes these head maps in
        place of the model's."""
        seen = {}

        def spy(preds, *a, **k):
            seen["maps"] = preds
            seen.update(predict(preds if maps is None else maps, *a, **k))
            return seen

        ta.multi_group_predict = spy
        try:
            inputs = ta.estimator_inputs(bundle, batch)
        finally:
            ta.multi_group_predict = predict
        idx = [te.pool_index(inputs["points"][b], inputs["points_valid"][b], inputs["boxes"][b],
                             EST_MAX_PTS) for b in range(B)]
        est = copy.deepcopy(estimator)
        loss = ta.estimator_loss(est, **inputs)
        loss.backward()
        grad = torch.cat([p.grad.flatten() for p in est.parameters()])
        return (inputs, idx, float(loss.detach()), grad,
                seen["scores"][:, :inputs["boxes"].shape[1]], seen["maps"])

    def compare(card, plain):
        (ci, cx, cl, cg, cs, _), (pi, px, pl, pg, ps, _) = card, plain
        # each valid card slot paired with the valid plain slot of the same
        # score (within 1e-5) and box (within 1e-3 of max(1, |box|)), greedily
        # by score
        pairs = []
        for b in range(B):
            cv = torch.nonzero(ci["det_valid"][b]).flatten().tolist()
            pv = torch.nonzero(pi["det_valid"][b]).flatten().tolist()
            used = set()
            for k in sorted(cv, key=lambda k: -float(cs[b, k])):
                for j in pv:
                    if j in used:
                        continue
                    tol = 1e-3 * max(1.0, float(ci["boxes"][b, k].abs().max()))
                    if (abs(float(cs[b, k]) - float(ps[b, j])) <= 1e-5
                            and float((ci["boxes"][b, k] - pi["boxes"][b, j]).abs().max()) <= tol):
                        used.add(j)
                        pairs.append((b, k, j))
                        break
        n_card, n_plain = int(ci["det_valid"].sum()), int(pi["det_valid"].sum())
        idx_same = all(torch.equal(cx[b][0][k], px[b][0][j])
                       and torch.equal(cx[b][1][k], px[b][1][j]) for b, k, j in pairs)
        t_gap = max((abs(float(ci["target"][b, k]) - float(pi["target"][b, j]))
                     for b, k, j in pairs), default=0.0)
        box_gap = max((float((ci["boxes"][b, k] - pi["boxes"][b, j]).abs().max())
                       for b, k, j in pairs), default=0.0)
        l_gap = abs(cl - pl) / max(abs(pl), 1e-30)
        g_gap = float((cg - pg).abs().max() / pg.norm().clamp(min=1e-30))
        interior = sum(int(cx[b][1][k].sum()) for b, k, _ in pairs)
        msg = (f"valid slots {n_card} and {n_plain}; {len(pairs)} paired by score and box; on "
               f"the pairs: pool indices and masks equal {idx_same} ({interior} interior points "
               f"pooled), box gap {box_gap:.2e}, target gap {t_gap:.2e} (tol 1e-5; targets > 0: "
               f"{int((ci['target'] > 0).sum())}); loss over every slot {cl:.6g} vs {pl:.6g} (rel "
               f"{l_gap:.2e}, tol 1e-5), gradient gap {g_gap:.2e} of its norm")
        ok = (n_card == n_plain and pairs and idx_same and t_gap <= 1e-5 and l_gap <= 1e-5
              and np.isfinite(cl))
        return ok, msg

    card = step()
    k1, k2 = bd.banded_conv, tiou.iou_matrix
    tiou.iou_matrix = tiou.iou_matrix_plain
    try:
        plain_k2 = step(maps=card[5])
        bd.banded_conv = bd.banded_conv_plain
        plain = step()
    finally:
        bd.banded_conv, tiou.iou_matrix = k1, k2
    map_gap = max(float((a[k] - b[k]).abs().max() / b[k].abs().max().clamp(min=1e-30))
                  for a, b in zip(card[5], plain[5]) for k in a)
    if not map_gap <= HEAD_MAP_TOL:
        fail(f"estimator step: the predict's head maps on K1 and on its plain version "
             f"{map_gap:.2e} of scale apart (tol {HEAD_MAP_TOL:g})")
    ok, msg_k2 = compare(card, plain_k2)
    if not ok:
        fail(f"estimator step on K1's head maps, K2 vs its plain version: {msg_k2}")
    ok, msg = compare(card, plain)
    if hold_plain and not ok:
        fail(f"estimator step, card vs both plain versions: {msg}")
    return (f"head maps K1 vs plain {map_gap:.2e} of scale (tol {HEAD_MAP_TOL:g}); on K1's maps, "
            f"K2 vs plain: {msg_k2}; both plain versions ({'held' if hold_plain else 'reported'}):"
            f" {msg}")


def partial_phase(tmp: str, dev, loop: dict, counters, bd, tiou, twin: dict) -> dict:
    """Phase 17: the partial-label round through the port's CLIs at full
    width. Returns each kernel's launches over the phase."""
    import re

    from dal3d_tpu_torch.data import DataLoader
    from dal3d_tpu_torch.models.builder import build_detector
    from dal3d_tpu_torch.runtime import checkpoint as ckpt
    from dal3d_tpu_torch.models.convert_flax import estimator_to_flat
    from dal3d_tpu_torch.runtime import active_trainer as ta
    from dal3d_tpu_torch.runtime.capacity import brick_capacity_report
    from dal3d_tpu_torch.tools import active_select, train
    from dal3d_tpu_torch.utils.config import Config
    from dal3d_tpu_torch.utils.fileio import load

    t_phase = time.perf_counter()
    base = os.path.join(tmp, "partial")
    os.makedirs(base)
    cfg_path, work = os.path.join(base, "partial.py"), os.path.join(base, "work")
    write_partial_config(cfg_path, loop, base, work)
    seed_file, sel_file = os.path.join(base, "partial_buffer.json"), os.path.join(base,
                                                                                  "partial.json")
    n_pool = len(load(loop["info_train"]))
    seconds, launches = {}, {}

    def counted(tag, fn, argv):
        for c in counters:
            c.launches = 0
        np.random.seed(LOOP_SEED)
        t0 = time.perf_counter()
        out = fn(argv)
        torch.cuda.synchronize()
        seconds[tag] = time.perf_counter() - t0
        launches[tag] = {c.__name__: c.launches for c in counters}
        return out

    def expect(tag, predicts, steps):
        want = {c.__name__: 0 for c in counters}
        want.update(banded_conv=K1_PER_PREDICT * predicts + K1_PER_TRAIN_STEP * steps,
                    iou_matrix=K2_PER_PREDICT * predicts, banded_dw=K3_PER_TRAIN_STEP * steps)
        if launches[tag] != want:
            fail(f"partial round, {tag}: launched {launches[tag]}, expected {want} ({predicts} "
                 f"predicts, {steps} train steps)")

    # 1. the ActiveTrainer epoch: a train step and an estimator step (one
    # predict on the batch's raw points) per iteration
    torch.cuda.reset_peak_memory_stats()
    tr = counted("train (ActiveTrainer)", train.main,
                 [cfg_path, "--epochs", "1", "--no_validate", "--seed", "0",
                  "--load_from", loop["work"]])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = tr.step
    if steps < 1 or tr.estimator_optimizer.count != steps:
        fail(f"partial round: {steps} train steps, {tr.estimator_optimizer.count} estimator steps")
    expect("train (ActiveTrainer)", steps, steps)
    seed = load(seed_file)
    with open(seed_file) as f:
        seed_text = f.read()
    ids = seed.get("partial_01", [])
    if (list(seed) != ["partial_01"] or len(ids) != int(n_pool * PARTIAL_RATIO)
            or len(set(ids)) != len(ids) or not seed_text.startswith('{\n    "partial_01"')):
        fail(f"partial round: seed buffer {seed_text!r}")
    est = dict(np.load(os.path.join(work, "estimator.npz")))
    widths = (4,) + EST_HIDDEN + (128, 1)
    ins = (4, EST_HIDDEN[0], EST_HIDDEN[1] + 5, 128)
    want_shapes = {}
    for i, (a, b) in enumerate(zip(ins, widths[1:])):
        want_shapes.update({f"Dense_{i}/kernel": (a, b), f"Dense_{i}/bias": (b,)})
    flat = estimator_to_flat(tr.estimator)
    if ({k: v.shape for k, v in est.items()} != want_shapes
            or not all(np.array_equal(est[k], flat[k]) for k in est)
            or not os.path.exists(os.path.join(work, "checkpoints", "epoch_1.pth"))):
        fail(f"partial round: estimator.npz {({k: v.shape for k, v in est.items()})}, expected "
             f"{want_shapes} and the trainer's weights; or no checkpoint")
    with open(os.path.join(work, "train.log")) as f:
        log = f.read()
    cap_line = re.findall(r"brick capacities \(active/cap, first batch\): ([^\n]*)", log)
    active = re.findall(r"\[active\] epoch 1: loss ([^,]+), estimator_loss (\S+)", log)
    it = re.findall(r"Epoch \[1\]\[\d+\] lr: [0-9.]+, time: ([0-9.]+) \(([0-9.]+) data\)", log)
    if len(cap_line) != 1 or len(active) != 1:
        fail(f"partial round: the train log has {len(cap_line)} capacity lines and "
             f"{len(active)} [active] lines")
    print(f"partial-label round through the CLIs (configs/cbgs_partial.py at full width, B={B}, "
          f"bf16 backbone, Estimator max_pts {EST_MAX_PTS} hidden {EST_HIDDEN}; phase 15's "
          f"{n_pool}-frame set, sample_ratio {PARTIAL_RATIO}):")
    print(f"  train: {steps} iterations in {seconds['train (ActiveTrainer)']:.2f} s (model build "
          f"and loader included); seed buffer partial_01 = {ids}; epoch means: detector loss "
          f"{active[0][0]}, estimator loss {active[0][1]}; peak memory {peak_gb:.2f} GB; "
          f"launches {launches['train (ActiveTrainer)']} (as expected: per iteration "
          f"{K1_PER_TRAIN_STEP} + {K1_PER_PREDICT} K1, {K2_PER_PREDICT} K2, "
          f"{K3_PER_TRAIN_STEP} K3); iterations as logged ("
          + ", ".join(f"{float(a) * 1e3:.0f} ({float(b) * 1e3:.0f} data)" for a, b in it)
          + " ms)")
    print(f"  capacity report of the CLI's first batch: {cap_line[0]}")

    # 2. per-iteration split on one batch of the partial set, and the
    # capacity rows for the production caps
    cfg = Config.fromfile(cfg_path)
    loader = DataLoader(partial_dataset(cfg), B, shuffle=False)
    np.random.seed(LOOP_SEED)
    batch = {k: v for k, v in next(iter(loader)).items() if k != "metadata"}
    rows = brick_capacity_report(tr.bundle, batch)
    print("  capacity rows (production banded caps; level 0 uncapped demand, levels 1-4 after "
          "compaction): " + ", ".join(
              f"L{r['level']} {r['active']}/{r['cap']}{' SATURATED' if r['saturated'] else ''}"
              for r in rows))
    opt = tr.estimator_optimizer
    parts = {"train step": [], "estimator predict + targets": [], "estimator pool": [],
             "estimator update (forward, loss, backward, Adam)": []}

    def timed(tag, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[tag].append((time.perf_counter() - t0) * 1e3)
        return out

    def update(inputs):
        opt.zero_grad()
        loss = ta.estimator_loss(tr.estimator, **inputs)
        loss.backward()
        opt.step()
        return loss

    for i in range(6):
        timed("train step", lambda: tr.train_step(batch))
        inputs = timed("estimator predict + targets", lambda: ta.estimator_inputs(tr.bundle, batch))
        with torch.no_grad():
            timed("estimator pool", lambda: tr.estimator.pool(inputs["points"],
                                                              inputs["points_valid"],
                                                              inputs["boxes"]))
        timed("estimator update (forward, loss, backward, Adam)", lambda: update(inputs))
        if i == 0:
            for v in parts.values():
                v.clear()  # the first round warms up
    med = {k: float(np.median(v)) for k, v in parts.items()}
    est_ms = med["estimator predict + targets"] + med["estimator update (forward, loss, backward, Adam)"]
    print(f"  one iteration, medians of 5 on a fixed batch (ms, synchronized): train step "
          f"{med['train step']:.2f}; estimator step {est_ms:.2f} = predict + targets "
          f"{med['estimator predict + targets']:.2f} + update {med['estimator update (forward, loss, backward, Adam)']:.2f} "
          f"(of which the pool alone {med['estimator pool']:.2f}) -> {med['train step'] + est_ms:.2f} "
          f"ms an iteration, the estimator {est_ms / (med['train step'] + est_ms):.3f} of it")

    # 3. the estimator step on the card against the same step on plain
    # versions, in f32
    cfg32_path = os.path.join(base, "partial_f32.py")
    write_partial_config(cfg32_path, loop, base, work, extra=(
        "model = copy.deepcopy(model)\nmodel['backbone']['dtype'] = 'float32'\n"))
    bundle32 = build_detector(Config.fromfile(cfg32_path), device="cuda")
    ckpt.load_checkpoint(work, bundle32.model)
    print("  estimator step from the trained checkpoint in f32, card vs plain versions: "
          + estimator_card_vs_plain(bundle32, tr.estimator, batch, bd, tiou))
    del bundle32
    # and on the overfit twin's checkpoint and scene (phase 16), where the
    # step's boxes hold points and its scores separate: held to the slot
    print("  the estimator step on the overfit twin's checkpoint and scene, card vs plain "
          "versions: " + estimator_card_vs_plain(twin["bundle"], tr.estimator, twin["batch"], bd,
                                                 tiou, hold_plain=True))
    del tr

    # 4. selection on the trained checkpoint, never re-picking partial_01
    for c in counters:
        c.launches = 0
    active_select.main([cfg_path])
    counted("active_select --checkpoint", active_select.main,
            [cfg_path, "--checkpoint", work, "--seed", "3407"])
    expect("active_select --checkpoint", -(-n_pool // B), 0)
    buf = load(sel_file)
    key = str(LOOP_BUDGET)
    picks = buf.get(key, [])
    if sorted(buf) != ["0", key] or not picks or set(picks) & set(ids):
        fail(f"partial round: selection {buf} (seed set {ids})")

    # 5. the next round: the partial dataset on the new budget key
    cfg2_path = os.path.join(base, "partial_round2.py")
    write_partial_config(cfg2_path, loop, base, os.path.join(base, "work_round2"), extra=(
        f"active_buffer = {sel_file!r}\nactive_flag = {key!r}\n"))
    tr2 = counted(f"train (active_flag {key})", train.main,
                  [cfg2_path, "--epochs", "1", "--no_validate", "--seed", "0"])
    steps2 = tr2.step
    del tr2
    infos = load(loop["info_train"])
    picked = {infos[i]["token"] for i in picks}
    ds2 = partial_dataset(Config.fromfile(cfg2_path))
    if steps2 < 1 or not {i["token"] for i in ds2.infos} <= picked:
        fail(f"partial round 2: {steps2} steps on {len(ds2)} frames outside the picks")
    expect(f"train (active_flag {key})", steps2, steps2)
    # this round's detector starts from random weights and diverges for a
    # while: slots without a detection decode boxes of infinite size, which
    # the estimator's loss must leave out
    with open(os.path.join(base, "work_round2", "train.log")) as f:
        active2 = re.findall(r"\[active\] epoch 1: loss ([^,]+), estimator_loss (\S+)",
                             f.read())
    if len(active2) != 1 or not np.isfinite(float(active2[0][1])):
        fail(f"partial round 2: the train log's [active] lines {active2} (a finite estimator "
             "loss expected)")
    total = {c.__name__: sum(v[c.__name__] for v in launches.values()) for c in counters}
    print(f"  active_select (EntropySelector, exclude_buffer): picks {picks}, disjoint from "
          f"partial_01; the next train on budget key {key}: {steps2} iterations, epoch means: "
          f"detector loss {active2[0][0]}, estimator loss {active2[0][1]}; "
          + "; ".join(f"{k} {v:.2f} s" for k, v in seconds.items()))
    print(f"phase 17 (partial-label round): {time.perf_counter() - t_phase:.1f} s; launches "
          f"{total}")
    return dict(launches=total, steps=steps, split_ms=med, peak_gb=peak_gb)


# ---------------------------------------------------------------------------
# phase 18: BEVFusion lidar-only training: K4 forward and input gradient,
# K4-dW, K5 and its backward, the Hungarian kernel, the step, the CLI
# ---------------------------------------------------------------------------
K4_PER_BF_TRAIN_STEP = 21 + 20  # forward, and an input gradient for every conv but the stem
K4_DW_PER_BF_TRAIN_STEP = 21  # every conv's weight trains
K5_PER_BF_TRAIN_STEP = 1
LSA_PER_BF_TRAIN_STEP = 1
BF_TRAIN_ITERS = 5
BF_GT = (120, 200)  # GT boxes of the two frames, of the config's max_gt = 200 slots
DW_TOL = 1e-5  # of the result's scale: 3xTF32 products, f32 sums in another order
# the whole gradient against plain versions, of its norm: at least 1e-3, and
# twice the gap that rounding alone opens (the plain step, with the same
# queries and matching, on voxel features moved by about one ulp: 1.7e-3 of
# the norm at full width with random weights on an H100, where the
# train-mode batch norms' backward cancels), that floor at most STEP_FLOOR_MAX
STEP_TOL = 1e-3
STEP_FLOOR_MAX = 1e-2
# nuScenes class sizes (w, l, h) and box bottoms, for seeded GT
BF_SIZES = ((1.95, 4.6, 1.7), (2.5, 6.9, 2.8), (2.8, 6.4, 3.2), (2.9, 11.0, 3.5),
            (2.9, 12.3, 3.9), (2.5, 0.5, 1.0), (0.8, 2.1, 1.5), (0.6, 1.7, 1.3),
            (0.7, 0.7, 1.8), (0.4, 0.4, 1.1))


def bevfusion_gt(seed: int) -> tuple:
    """Seeded GT of the two frames: [B, 200, 9] boxes (lidar frame, centre z)
    of the nuScenes classes near their sizes over +-50 m, BF_GT of them, and
    [B, 200] classes 1..10 (0 = padding)."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((B, 200, 9), np.float32)
    boxes[..., 3:6] = 1.0
    classes = np.zeros((B, 200), np.int32)
    for b, n in enumerate(BF_GT):
        c = rng.randint(0, 10, n)
        size = np.asarray(BF_SIZES, np.float32)[c] * rng.uniform(0.9, 1.1, (n, 3))
        boxes[b, :n, :2] = rng.uniform(-50, 50, (n, 2))
        boxes[b, :n, 2] = -1.8 + size[:, 2] / 2
        boxes[b, :n, 3:6] = size
        boxes[b, :n, 6:8] = rng.uniform(-2, 2, (n, 2))
        boxes[b, :n, 8] = rng.uniform(-np.pi, np.pi, n)
        classes[b, :n] = c + 1
    return boxes, classes


def gemm_plain_over_plan(tg, features, plan, weights):
    """What one K4 launch computes over its plan, in plain PyTorch: the rows
    in plan order, written back to their rows through ``order``."""
    rb = plan.rulebook
    out = tg.gather_gemm_plain(features, rb.clamp(min=0), rb >= 0, weights)
    if plan.order is not None:
        out = torch.empty_like(out).scatter_(1, plan.order[..., None].expand_as(out), out)
    return out


def dw_plain_over_plan(tg, features, plan, g):
    """What one K4-dW launch computes over its plan (g's rows taken in plan
    order), in plain PyTorch."""
    rb = plan.rulebook
    if plan.order is not None:
        g = torch.gather(g, 1, plan.order[..., None].expand_as(g))
    return tg.gather_dw_plain(features, rb.clamp(min=0), rb >= 0, g)


def library_gather_dw(features, plan, g):
    """Yardstick the port never calls: one index_select of every (tap,
    position) row, then one batched cuBLAS matmul [K, Cin, B*M] x [B*M,
    Cout]."""
    Bt, N, Cin = features.shape
    rb = plan.rulebook
    K, M = rb.shape[1], rb.shape[2]
    flat = torch.cat([features.reshape(Bt * N, Cin), features.new_zeros(1, Cin)])
    base = (torch.arange(Bt, device=rb.device) * N)[:, None, None]
    sel = torch.where(rb >= 0, rb.long() + base, Bt * N).permute(1, 0, 2).reshape(-1)
    if plan.order is not None:
        g = torch.gather(g, 1, plan.order[..., None].expand_as(g))
    gf = g.reshape(1, Bt * M, -1).expand(K, Bt * M, g.shape[-1])

    def run():
        gat = flat.index_select(0, sel).view(K, Bt * M, Cin)
        return torch.bmm(gat.transpose(1, 2), gf)

    return run


def gather_dw_bound_ms(features, plan, g) -> dict:
    """Least times (ms) of one K4-dW launch: bytes (features, rulebook, g read
    once, dW written once), the f32 FMA route and the 3xTF32 route over
    2 * hits * Cin * Cout operations; "bound" the larger of the bytes and the
    lesser operation route."""
    K, Cin, Cout = plan.rulebook.shape[1], features.shape[-1], g.shape[-1]
    nbytes = (features.numel() + plan.rulebook.numel() + g.numel() + K * Cin * Cout) * 4
    ops = 2.0 * int((plan.rulebook >= 0).sum()) * Cin * Cout
    t = dict(bytes=nbytes / PEAK_BYTES * 1e3, fma=ops / PEAK_F32 * 1e3,
             tc=3 * ops / PEAK_TF32 * 1e3)
    t_ops = min(t["fma"], t["tc"])
    t["bound"], t["by"] = (t["bytes"], "bytes") if t["bytes"] >= t_ops else (t_ops, "operations")
    return t


def reference_bevfusion_state_dict(rng) -> dict:
    """Seeded mmdet3d-named TransFusion-L weights at the production config's
    widths (configs/bevfusion_lidar.py), as tests/test_convert_bevfusion.py
    builds them at small widths: spconv [kx, ky, kz, Cin, Cout], BEV convs
    [Cout, Cin, kh, kw], Conv1d heads, torch attention in_proj."""
    sd = {}

    def w(name, *shape, fan):
        sd[f"{name}.weight"] = (rng.randn(*shape) / np.sqrt(fan)).astype(np.float32)

    def bias(name, n):
        sd[f"{name}.bias"] = (0.05 * rng.randn(n)).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = (1 + 0.2 * rng.randn(c)).astype(np.float32)
        sd[f"{name}.bias"] = (0.1 * rng.randn(c)).astype(np.float32)
        sd[f"{name}.running_mean"] = (0.1 * rng.randn(c)).astype(np.float32)
        sd[f"{name}.running_var"] = (1 + 0.1 * rng.rand(c)).astype(np.float32)

    enc = ((16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128))
    eb = "encoders.lidar.backbone"
    w(f"{eb}.conv_input.0", 3, 3, 3, 5, 16, fan=135)
    bn(f"{eb}.conv_input.1", 16)
    for i, ch in enumerate(enc):
        layer = f"{eb}.encoder_layers.encoder_layer{i + 1}"
        for j in (0, 1):
            for n in (1, 2):
                w(f"{layer}.{j}.conv{n}", 3, 3, 3, ch[0], ch[0], fan=27 * ch[0])
                bn(f"{layer}.{j}.bn{n}", ch[0])
        if i < 3:
            w(f"{layer}.2.0", 3, 3, 3, ch[0], ch[-1], fan=27 * ch[0])
            bn(f"{layer}.2.1", ch[-1])
    w(f"{eb}.conv_out.0", 1, 1, 3, 128, 128, fan=384)
    bn(f"{eb}.conv_out.1", 128)
    cin = 256
    for b, co in enumerate((128, 256)):
        for j in range(6):  # the lead conv and 5 layer convs
            w(f"decoder.backbone.blocks.{b}.{3 * j}", co, cin if j == 0 else co, 3, 3,
              fan=9 * (cin if j == 0 else co))
            bn(f"decoder.backbone.blocks.{b}.{3 * j + 1}", co)
        cin = co
    w("decoder.neck.deblocks.0.0", 256, 128, 1, 1, fan=128)
    bn("decoder.neck.deblocks.0.1", 256)
    w("decoder.neck.deblocks.1.0", 256, 256, 2, 2, fan=1024)
    bn("decoder.neck.deblocks.1.1", 256)
    hd, d = "heads.object", 128
    w(f"{hd}.shared_conv", d, 512, 3, 3, fan=4608)
    bias(f"{hd}.shared_conv", d)
    w(f"{hd}.heatmap_head.0.conv", d, d, 3, 3, fan=9 * d)
    bn(f"{hd}.heatmap_head.0.bn", d)
    w(f"{hd}.heatmap_head.1", 10, d, 3, 3, fan=9 * d)
    bias(f"{hd}.heatmap_head.1", 10)
    w(f"{hd}.class_encoding", d, 10, 1, fan=10)
    bias(f"{hd}.class_encoding", d)
    for pe in ("self_posembed", "cross_posembed"):
        pre = f"{hd}.decoder.0.{pe}.position_embedding_head"
        w(f"{pre}.0", d, 2, 1, fan=2)
        bias(f"{pre}.0", d)
        bn(f"{pre}.1", d)
        w(f"{pre}.3", d, d, 1, fan=d)
        bias(f"{pre}.3", d)
    dl = f"{hd}.decoder.0"
    for att in ("self_attn", "multihead_attn"):
        sd[f"{dl}.{att}.in_proj_weight"] = (rng.randn(3 * d, d) / np.sqrt(d)).astype(np.float32)
        sd[f"{dl}.{att}.in_proj_bias"] = (0.05 * rng.randn(3 * d)).astype(np.float32)
        w(f"{dl}.{att}.out_proj", d, d, fan=d)
        bias(f"{dl}.{att}.out_proj", d)
    w(f"{dl}.linear1", 256, d, fan=d)
    bias(f"{dl}.linear1", 256)
    w(f"{dl}.linear2", d, 256, fan=256)
    bias(f"{dl}.linear2", d)
    for i in (1, 2, 3):
        sd[f"{dl}.norm{i}.weight"] = (1 + 0.1 * rng.randn(d)).astype(np.float32)
        bias(f"{dl}.norm{i}", d)
    for branch, out in (("center", 2), ("height", 1), ("dim", 3), ("rot", 2), ("vel", 2),
                        ("heatmap", 10)):
        pb = f"{hd}.prediction_heads.0.{branch}"
        w(f"{pb}.0.conv", 64, d, 1, fan=d)
        bn(f"{pb}.0.bn", 64)
        w(f"{pb}.1", out, 64, 1, fan=64)
        bias(f"{pb}.1", out)
    return sd


def step_gradients(bundle, inputs, gt, step_idx: int, plain: bool, tg, tl, queries=None,
                   assignment=None, seg=None):
    """One train step's forward, loss and backward without the update (the
    dropout masks of step ``step_idx``), with the kernels or with every
    kernel swapped for its plain version. ``queries`` (top-k indices) and
    ``assignment`` (col4row) of an earlier run make the head take those
    queries and the loss that matching instead of its own; ``seg`` (map
    targets [B, Hc, Wc, C] on the device) adds the step's map-segmentation
    loss. Returns (logs, {name: grad}, {"queries", "cost", "col4row"} of this
    run). The running statistics are put back afterwards."""
    from dal3d_tpu_torch.models.bevfusion import transfusion as ttf
    from dal3d_tpu_torch.models.bevfusion.transfusion import transfusion_loss
    from dal3d_tpu_torch.runtime.bevfusion_steps import (_forward, autotuned_convs,
                                                         dropout_generator, random_modules,
                                                         seg_loss_of)

    model = bundle.model
    model.train()
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    gen = dropout_generator(bundle.device, step_idx)
    for m in random_modules(model):
        m.generator = gen
    model.zero_grad(set_to_none=True)
    taken = {}
    top_k = ttf.top_k
    solve = tl.linear_sum_assignment_plain if plain else tl.linear_sum_assignment

    def recording_top_k(x, k):
        vals, idx = top_k(x, k) if queries is None else (torch.gather(x, -1, queries), queries)
        taken["queries"] = idx.clone()
        return vals, idx

    def recording_solve(cost):
        taken["cost"] = cost.clone()
        taken["col4row"] = solve(cost) if assignment is None else assignment
        return taken["col4row"]

    saved = tg.gather_gemm, tg.gather_rows, tl.linear_sum_assignment
    recording_solve.launches = saved[2].launches  # the wrapper counts on this attribute
    ttf.top_k, tl.linear_sum_assignment = recording_top_k, recording_solve
    if plain:
        tg.gather_gemm = lambda f, idx, hit, w, plan=None: tg.gather_gemm_plain(f, idx, hit, w)
        tg.gather_rows = tg.gather_rows_plain
    try:
        with autotuned_convs():
            preds = _forward(model, inputs)
            logs = transfusion_loss(preds, *gt, bundle.test_cfg)
            if seg is not None:
                logs["seg_loss"] = seg_loss_of(preds, {"gt_masks_bev": seg}, bundle.device)
                logs["loss"] = logs["loss"] + logs["seg_loss"]
            logs["loss"].backward()
        torch.cuda.synchronize()
    finally:
        tg.gather_gemm, tg.gather_rows, tl.linear_sum_assignment = saved
        saved[2].launches = recording_solve.launches
        ttf.top_k = top_k
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k in stats:
                v.copy_(stats[k])
    return {k: v.detach() for k, v in logs.items()}, grads, taken


def _assignment_cost(cost: torch.Tensor, col4row: torch.Tensor) -> float:
    """The total cost of an assignment (col4row [B, G], -1 unmatched) under
    cost [B, G, P] over the valid GT rows (the padded ones cost 1e6 whatever
    they take), in f64."""
    c = cost.double()
    rows = (col4row >= 0) & (c[:, :, 0] < 1e5)
    got = torch.gather(c, 2, col4row.clamp(min=0).long()[..., None])[..., 0]
    return float(torch.where(rows, got, torch.zeros_like(got)).sum())


def _grad_gap(ref: dict, got: dict) -> float:
    """|got - ref| / |ref| over all parameters."""
    num = sum(float(((got[n] - g).double() ** 2).sum()) for n, g in ref.items())
    den = sum(float((g.double() ** 2).sum()) for g in ref.values())
    return (num / den) ** 0.5


def bevfusion_train_split(bundle, opt, inputs, gt, iters: int, seg=None) -> dict:
    """Host-clock split of a train step with a synchronize after each part
    (median of ``iters`` after one warm-up): forward, assignment + loss,
    with ``seg`` (map targets on the device) the seg loss (its resize
    included), backward, optimizer."""
    from dal3d_tpu_torch.models.bevfusion.transfusion import transfusion_loss
    from dal3d_tpu_torch.runtime.bevfusion_steps import _forward, autotuned_convs, seg_loss_of

    model = bundle.model
    model.train()
    names = ["forward", "assignment + loss"] + (["seg loss"] if seg is not None else []) + [
        "backward", "optimizer"]
    rec = {n: [] for n in names}
    for _ in range(iters + 1):
        opt.zero_grad()
        marks = [time.perf_counter()]
        with autotuned_convs():
            preds = _forward(model, inputs)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            logs = transfusion_loss(preds, *gt, bundle.test_cfg)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            if seg is not None:
                logs["loss"] = logs["loss"] + seg_loss_of(preds, {"gt_masks_bev": seg},
                                                          bundle.device)
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
            logs["loss"].backward()
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        opt.step()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        for n, a, b_ in zip(names, marks[:-1], marks[1:]):
            rec[n].append((b_ - a) * 1e3)
    return {n: float(np.median(v[1:])) for n, v in rec.items()}


def write_bevfusion_cli_config(path: str, loop: dict, work_dir: str, extra: str = "") -> None:
    """configs/bevfusion_lidar.py (full width) pointed at phase 15's
    synthetic set, a log line every step."""
    with open(path, "w") as f:
        f.write(open(os.path.join(ROOT, "configs", "bevfusion_lidar.py")).read())
        f.write(f"\ndata['train'].update(root_path={loop['root']!r}, "
                f"info_path={loop['info_train']!r})\nwork_dir = {work_dir!r}\n"
                "log_config = dict(interval=1)\n" + extra)


def bevfusion_train_cli(tmp: str, loop: dict) -> dict:
    """The training CLI on phase 15's synthetic set at full width: an epoch
    with --budget and its checkpoint, --resume_from, --load_from into a model
    with another head width, convert_bevfusion -> --torch_init. Returns
    seconds per run."""
    from dal3d_tpu_torch.models.bevfusion.convert_bevfusion import (
        apply_torch_init_bevfusion, convert_bevfusion_state_dict)
    from dal3d_tpu_torch.models.builder import build_bevfusion
    from dal3d_tpu_torch.runtime import checkpoint as ckpt
    from dal3d_tpu_torch.tools import convert_bevfusion, train_bevfusion
    from dal3d_tpu_torch.utils.config import Config

    base = os.path.join(tmp, "bevfusion_train")
    os.makedirs(base)
    cfg_path, work = os.path.join(base, "bevfusion.py"), os.path.join(base, "work")
    write_bevfusion_cli_config(cfg_path, loop, work)
    budget = ["--budget", loop["budget"]]
    seconds = {}

    def run(tag, argv):
        t0 = time.perf_counter()
        out = train_bevfusion.main(argv)
        torch.cuda.synchronize()
        seconds[tag] = time.perf_counter() - t0
        return out

    r1 = run("epoch (--budget)", [cfg_path, "--epochs", "1"] + budget)
    n1 = r1["optimizer"].count
    if ckpt.latest_epoch(work) != 1 or n1 < 1 or not all(
            np.isfinite(v) for v in r1["logs"].values()):
        fail(f"train_bevfusion --budget: epoch {ckpt.latest_epoch(work)}, {n1} steps, logs "
             f"{r1['logs']}")
    del r1
    r2 = run("--resume_from", [cfg_path, "--epochs", "2", "--resume_from", work] + budget)
    if ckpt.latest_epoch(work) != 2 or r2["optimizer"].count != 2 * n1:
        fail(f"train_bevfusion --resume_from: epoch {ckpt.latest_epoch(work)}, step "
             f"{r2['optimizer'].count} (expected {2 * n1})")
    del r2
    wide = os.path.join(base, "wide.py")
    write_bevfusion_cli_config(wide, loop, os.path.join(base, "wide"),
                               "model = dict(model, hidden_channel=64, ffn_channel=128)\n")
    r3 = run("--load_from (head width 64)", [wide, "--epochs", "1", "--load_from", work] + budget)
    log = open(os.path.join(base, "wide", "train.log")).read()
    copied = int(log.split("partial warm-start from ")[1].split(": ")[1].split(" ")[0])
    if copied <= 0 or r3["optimizer"].count != n1:
        fail(f"train_bevfusion --load_from: {copied} tensors copied, {r3['optimizer'].count} "
             "steps")
    del r3
    ref = reference_bevfusion_state_dict(np.random.RandomState(18))
    pth, npz = os.path.join(base, "reference.pth"), os.path.join(base, "reference.npz")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in ref.items()}}, pth)
    convert_bevfusion.main([pth, npz, "--config", cfg_path])
    model = build_bevfusion(Config.fromfile(cfg_path), seed=3).model
    apply_torch_init_bevfusion(model, npz)
    want = convert_bevfusion_state_dict(ref, model)
    if set(want) != set(model.state_dict()) or not all(
            torch.equal(v.cpu(), want[k]) for k, v in model.state_dict().items()):
        fail("convert_bevfusion -> apply_torch_init_bevfusion: loaded tensors differ from the "
             "written ones")
    del model
    r4 = run("--torch_init", [cfg_path, "--epochs", "1", "--work_dir",
                              os.path.join(base, "torch_init"), "--torch_init", npz] + budget)
    if not all(np.isfinite(v) for v in r4["logs"].values()):
        fail(f"train_bevfusion --torch_init: logs {r4['logs']}")
    del r4
    print(f"  train_bevfusion CLI ({n1} steps an epoch on the budget-{loop['budget']} subset): "
          + "; ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
          + f"; --load_from copied {copied} tensors; --torch_init of {len(ref)} reference "
          "tensors, the loaded ones equal to the written ones")
    return seconds


def bevfusion_train_phase(tmp: str, Config, counters, loop, tg, tl) -> dict:
    """Phase 18. Returns the kernels-line numbers of K4-dW and LSA, and each
    kernel's launches over the phase's main-path run."""
    import contextlib

    from dal3d_tpu_torch.models.bevfusion import transfusion as ttf
    from dal3d_tpu_torch.models.builder import bevfusion_optimizer, build_bevfusion
    from dal3d_tpu_torch.runtime.bevfusion_steps import make_bevfusion_train_step
    from dal3d_tpu_torch.runtime.steps import _to_device, model_inputs
    from scipy.optimize import linear_sum_assignment as scipy_lsa

    t_phase = time.perf_counter()
    cfg = Config.fromfile(os.path.join(ROOT, "configs", "bevfusion_lidar.py"))
    batch, _, _ = bevfusion_batch(10, cfg)
    batch["gt_boxes"], batch["gt_classes"] = bevfusion_gt(18)
    bundle = build_bevfusion(cfg, seed=0)
    dev = bundle.device
    opt = bevfusion_optimizer(cfg, bundle, 100)
    step = make_bevfusion_train_step(bundle, opt)
    inputs = model_inputs(batch, dev)
    gt = (_to_device(batch["gt_boxes"], dev, torch.float32),
          _to_device(batch["gt_classes"], dev, torch.int32))

    # 1. the whole step's gradient against the same step on plain versions;
    # the plain run takes the kernel run's queries (top-k is discontinuous:
    # rounding can swap a query at the 200th place), and the plain run again
    # on features moved by about one ulp gives the floor rounding alone sets
    logs_k, g_k, rk = step_gradients(bundle, inputs, gt, 0, False, tg, tl)
    q_k, a_k = rk["queries"], rk["col4row"]
    own = step_gradients(bundle, inputs, gt, 0, True, tg, tl, assignment=a_k)[2]["queries"]
    a_own = step_gradients(bundle, inputs, gt, 0, True, tg, tl, queries=q_k)[2]["col4row"]
    logs_p, g_p, _ = step_gradients(bundle, inputs, gt, 0, True, tg, tl, queries=q_k,
                                    assignment=a_k)
    noise = 1.0 + 1e-7 * torch.randn(inputs["vf"].shape, generator=torch.Generator().manual_seed(
        18)).to(dev)
    _, g_n, _ = step_gradients(bundle, dict(inputs, vf=inputs["vf"] * noise), gt, 0, True, tg,
                               tl, queries=q_k, assignment=a_k)
    # the plain run's own matching on its own cost may differ from the
    # kernel's only by a tie: the same total cost under the kernel run's cost
    tie_cost = (_assignment_cost(rk["cost"], a_k), _assignment_cost(rk["cost"], a_own))
    a_flips = int((a_own != a_k).sum())
    if abs(tie_cost[1] - tie_cost[0]) > 1e-5 * max(abs(tie_cost[0]), 1.0):
        fail(f"BEVFusion train step: the plain run's own matching differs from the kernel "
             f"run's in {a_flips} rows and costs {tie_cost[1]} against {tie_cost[0]}")
    stem = "encoder.stem.weight"
    gap, floor = _grad_gap(g_p, g_k), _grad_gap(g_p, g_n)
    stem_gap = _grad_gap({stem: g_p[stem]}, {stem: g_k[stem]})
    stem_floor = _grad_gap({stem: g_p[stem]}, {stem: g_n[stem]})
    tol, stem_tol = max(STEP_TOL, 2 * floor), max(STEP_TOL, 2 * stem_floor)
    log_gap = max(abs(float(logs_k[k]) - float(logs_p[k])) / max(abs(float(logs_p[k])), 1e-30)
                  for k in ("loss", "cls_loss", "reg_loss", "heatmap_loss"))
    flips = int((own != q_k).sum())
    if not (gap <= tol and stem_gap <= stem_tol and max(floor, stem_floor) <= STEP_FLOOR_MAX
            and float(g_k[stem].abs().max()) > 0
            and int(logs_k["num_matched"]) == int(logs_p["num_matched"]) == sum(BF_GT)
            and log_gap <= 1e-4):
        fail(f"BEVFusion train step vs plain versions: gradient gap {gap:.2e} of its norm "
             f"(tol {tol:.2e}; rounding floor {floor:.2e}), the stem's {stem_gap:.2e} (tol "
             f"{stem_tol:.2e}), logs gap {log_gap:.2e}, matched {int(logs_k['num_matched'])} / "
             f"{int(logs_p['num_matched'])}")
    print(f"BEVFusion train step (B={B}, {BF_GT} GT boxes) vs the same step on plain versions "
          f"with the kernel run's queries and matching ({flips} of {q_k.numel()} queries differ "
          f"in the plain run's own top-k; with the kernel run's queries its own matching "
          f"differs in {a_flips} of {a_k.numel()} rows, at the same total cost: "
          f"{tie_cost[1]:.6f} against {tie_cost[0]:.6f}): gradient within {gap:.2e} of its norm (tol {tol:.2e}), the stem's within "
          f"{stem_gap:.2e} (tol {stem_tol:.2e}, nonzero); rounding alone (the plain step on "
          f"features moved by about one ulp) opens {floor:.2e} (the stem's {stem_floor:.2e}); "
          f"loss and its parts within {log_gap:.1e}, the same {int(logs_k['num_matched'])} "
          "matches")
    dw_gap = dict(gap=gap, floor=floor, stem_gap=stem_gap, stem_floor=stem_floor,
                  query_flips=flips, matching_flips=a_flips)
    del g_k, g_p, g_n, logs_p

    # 2. every launch of one step against its plain version
    with Capture(tg, "_launch_gemm") as k4, Capture(tg, "_launch_dw") as kdw, \
            Capture(tl, "linear_sum_assignment") as klsa, Capture(ttf, "boxes_iou3d") as kiou:
        logs = {k: float(v) for k, v in step(batch).items()}
        torch.cuda.synchronize()
    if (len(k4.calls), len(kdw.calls), len(klsa.calls)) != (
            K4_PER_BF_TRAIN_STEP, K4_DW_PER_BF_TRAIN_STEP, LSA_PER_BF_TRAIN_STEP):
        fail(f"capture step launched K4 {len(k4.calls)}x, K4-dW {len(kdw.calls)}x, LSA "
             f"{len(klsa.calls)}x")
    dx_err = 0.0
    for n, (f, plan, w) in enumerate(k4.calls[K4_PER_PREDICT:]):
        got, ref = tg._launch_gemm(f, plan, w), gemm_plain_over_plan(tg, f, plan, w)
        scale = max(float(ref.abs().max()), 1e-30)
        err = float((got - ref).abs().max()) / scale
        if not err <= K4_TOL:
            fail(f"K4 input-gradient launch {n} {tuple(f.shape)} x {tuple(w.shape)} "
                 f"({'symmetric plan' if plan.symmetric else 'inverse rulebook'}): error "
                 f"{err:.2e} of scale > {K4_TOL:g}")
        dx_err = max(dx_err, err)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, t_bytes=0.0, t_ops=0.0,
               fma_ms=0.0, tc_ms=0.0, flops=0.0)
    worst_abs = worst_rel = 0.0
    routes = []
    print(f"K4-dW launches of one BEVFusion train step (kernel vs plain, f32; tol = {DW_TOL:g} "
          "x max|plain|, bit-equal on a repeat; library = index_select + bmm):")
    for n, (f, plan, g) in enumerate(kdw.calls):
        got, ref = tg._launch_dw(f, plan, g), dw_plain_over_plan(tg, f, plan, g)
        scale = max(float(ref.abs().max()), 1e-30)
        err = float((got - ref).abs().max())
        if not err <= DW_TOL * scale or float(ref.abs().max()) == 0.0:
            fail(f"K4-dW launch {n} {tuple(f.shape)} g {tuple(g.shape)}: max_abs_err {err:.3e} "
                 f"> {DW_TOL * scale:.3e}")
        if not torch.equal(got, tg._launch_dw(f, plan, g)):
            fail(f"K4-dW launch {n}: a second call on the same inputs differs")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, err / scale)
        ms = cuda_time_ms(lambda: tg._launch_dw(f, plan, g), 5)
        pms = cuda_time_ms(lambda: dw_plain_over_plan(tg, f, plan, g), 2)
        lms = cuda_time_ms(library_gather_dw(f, plan, g), 2)
        bnd = gather_dw_bound_ms(f, plan, g)
        hits = int((plan.rulebook >= 0).sum())
        flops = 2.0 * hits * f.shape[-1] * g.shape[-1]
        for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms), ("bound_ms", bnd["bound"]),
                     ("fma_ms", bnd["fma"]), ("tc_ms", bnd["tc"]), ("flops", flops)):
            tot[k] += v
        tot["t_" + ("bytes" if bnd["by"] == "bytes" else "ops")] += bnd["bound"]
        ti, to = tg._dw_tiles(f.shape[-1], g.shape[-1])
        routes.append(f"wgmma m64n{to}k8, tile {ti}x{to}")
        print(f"  #{n:2d} features {tuple(f.shape)} taps {plan.rulebook.shape[1]} M "
              f"{plan.rulebook.shape[2]} Cout {g.shape[-1]} hits {hits} "
              f"({'sorted' if plan.order is not None else 'in order'}): route {routes[-1]}; "
              f"err {err / scale:.1e} of scale; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
              f"TFLOP/s) plain {pms:.3f} library {lms:.4f}; bound {bnd['bound']:.4f} ms "
              f"({bnd['by']})")
    print(f"K4-dW per train step: kernel {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, "
          f"library {tot['library_ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms (FMA "
          f"{tot['fma_ms']:.3f}, 3xTF32 {tot['tc_ms']:.3f}); {tot['flops'] / tot['ms'] / 1e9:.1f} "
          f"TFLOP/s; max_abs_err {worst_abs:.3e} ({worst_rel:.2e} of scale); K4 input-gradient "
          f"launches within {dx_err:.2e} of scale")
    dw = dict(max_abs_err=worst_abs, ms=tot["ms"], plain_ms=tot["plain_ms"],
              bound_ms=tot["bound_ms"],
              bound_by="bytes" if tot["t_bytes"] >= tot["t_ops"] else "operations",
              library_ms=tot["library_ms"], bound_fma_ms=tot["fma_ms"],
              bound_3xtf32_ms=tot["tc_ms"], dx_max_rel_err=dx_err,
              wgmma_launches=sum(r.startswith("wgmma") for r in routes))

    # the Hungarian kernel on the step's cost
    (cost,) = klsa.calls[0]
    got = tl.linear_sum_assignment(cost)
    steps0 = tl.linear_sum_assignment_plain.relax_steps
    t0 = time.perf_counter()
    twin = tl.linear_sum_assignment_plain(cost)
    torch.cuda.synchronize()
    twin_ms = (time.perf_counter() - t0) * 1e3
    relax = tl.linear_sum_assignment_plain.relax_steps - steps0
    per_problem = []
    for b_ in range(cost.shape[0]):
        s0 = tl.linear_sum_assignment_plain.relax_steps
        tl.linear_sum_assignment_plain(cost[b_:b_ + 1].cpu())
        per_problem.append(tl.linear_sum_assignment_plain.relax_steps - s0)
    cost_np = cost.cpu().numpy().astype(np.float64)
    t0 = time.perf_counter()
    sci = [scipy_lsa(c) for c in cost_np]
    scipy_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(got, twin):
        fail(f"LSA kernel vs plain: col4row differs at {(got != twin).nonzero().tolist()[:5]}")
    Gc, Pc = cost.shape[1], cost.shape[2]
    for b_, (r, c) in enumerate(sci):
        have = float(cost_np[b_][np.arange(Gc), got[b_].cpu().numpy()].sum())
        want = float(cost_np[b_][r, c].sum())
        if not abs(have - want) <= 1e-5 * max(abs(want), 1.0):
            fail(f"LSA kernel: total cost {have} against scipy's {want}")
    lsa_ms = cuda_time_ms(lambda: tl.linear_sum_assignment(cost), 5)
    nbytes = cost.numel() * 4 + got.numel() * 4
    lsa_ops = relax * (Pc + 1) * 8.0  # relax, mask, argmin and update: about 8 per column
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, lsa_ops / PEAK_F32 * 1e3
    lsa = dict(max_abs_err=0.0, ms=lsa_ms, plain_ms=twin_ms, library_ms=None, scipy_ms=scipy_ms,
               bound_ms=max(t_b, t_o), bound_by="bytes" if t_b >= t_o else "operations",
               relax_steps=relax, relax_steps_per_problem=per_problem,
               us_per_relax_step=lsa_ms / relax * 1e3)
    print(f"LSA cost {tuple(cost.shape)} ({int((cost[:, :, 0] < 1e5).sum())} valid GT rows): "
          f"col4row equal to the plain version's, total cost equal to scipy's; kernel "
          f"{lsa_ms:.4f} ms ({lsa_ms / relax * 1e3:.4f} us a relax step over the {relax} "
          f"steps of both problems; the longer problem's {max(per_problem)} steps run one after "
          f"another: {lsa_ms / max(per_problem) * 1e3:.4f} us each), plain on the card "
          f"{twin_ms:.1f} ms (a host sync a step), scipy on the host {scipy_ms:.2f} ms; bound "
          f"{lsa['bound_ms']:.5f} ms ({lsa['bound_by']})")
    iou_ms = sum(cuda_time_ms(lambda a=a, b_=b_: ttf.boxes_iou3d(a, b_), 3) for a, b_ in kiou.calls)
    print(f"boxes_iou3d of the IoU cost: {len(kiou.calls)} calls of "
          f"{tuple(kiou.calls[0][0].shape)} x {tuple(kiou.calls[0][1].shape)}, {iou_ms:.2f} ms "
          "of device time a step (plain PyTorch, launch-bound)")
    # K5's backward: the rows' scatter-add (index_add_, not a kernel of the port)
    with torch.enable_grad():
        tbl = torch.randn(B, 180 * 180, 128, device=dev, requires_grad=True)
        rows = torch.randint(0, B * 180 * 180, (B * 200,), dtype=torch.int32, device=dev)
        q = tg.gather_rows(tbl, rows)
        gq = torch.randn_like(q)
        k5b_ms = cuda_time_ms(lambda: torch.autograd.grad(q, tbl, gq, retain_graph=True), 5)
    print(f"K5 backward (index_add_ of {B * 200} rows into a zero [{B}, 32400, 128] table, "
          f"float atomics): {k5b_ms:.4f} ms")
    del k4, kdw, klsa, kiou

    # 3. the main path: counters at 0, a warm-up and timed steps
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    step(batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(BF_TRAIN_ITERS):
        t0 = time.perf_counter()
        out = {k: float(v) for k, v in step(batch).items()}
        times.append((time.perf_counter() - t0) * 1e3)
    n_steps = BF_TRAIN_ITERS + 1
    launches = {c.__name__: c.launches for c in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {n: 0 for n in launches}
    want.update(gather_gemm=K4_PER_BF_TRAIN_STEP * n_steps,
                gather_dw=K4_DW_PER_BF_TRAIN_STEP * n_steps,
                gather_rows=K5_PER_BF_TRAIN_STEP * n_steps,
                linear_sum_assignment=LSA_PER_BF_TRAIN_STEP * n_steps)
    if launches != want:
        fail(f"BEVFusion train main path launched {launches} in {n_steps} steps; expected {want}")
    if not all(np.isfinite(v) for v in out.values()) or out["num_matched"] != sum(BF_GT):
        fail(f"BEVFusion train step logs {out}")
    ms_med = float(np.median(times))
    print(f"BEVFusion train step (B={B}, f32): median {ms_med:.2f} ms, mean {np.mean(times):.2f} "
          f"ms, min {min(times):.2f} ms over {BF_TRAIN_ITERS} steps; peak memory {peak_gb:.2f} "
          f"GB; launches per step: gather_gemm {launches['gather_gemm'] // n_steps} (21 "
          f"forward + 20 input gradients), gather_dw {launches['gather_dw'] // n_steps}, "
          f"gather_rows {launches['gather_rows'] // n_steps}, linear_sum_assignment "
          f"{launches['linear_sum_assignment'] // n_steps}, no other kernel; logs {out} "
          f"(first step {logs})")
    split = bevfusion_train_split(bundle, opt, inputs, gt, 3)
    print("BEVFusion train step split (ms, median of 3, synchronized per part): "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    prof = device_profile(lambda: step(batch), "BEVFusion train step", ms_med)
    for tag, key in (("K4", "gather_gemm_kernel"), ("K4-dW", "gather_dw"),
                     ("LSA", "lsa_kernel"), ("K5", "gather_rows_kernel")):
        ms_, n_ = (sum(v[0] for k, v in prof.items() if key in k),
                   sum(v[1] for k, v in prof.items() if key in k))
        print(f"  profile: {tag} {ms_:.3f} ms a step over {n_:.0f} kernels")

    # 4. the CLI on phase 15's synthetic set
    cli_s = bevfusion_train_cli(tmp, loop)
    print(f"phase 18 (BEVFusion training): {time.perf_counter() - t_phase:.1f} s; launches of "
          f"the main path {launches}")
    return dict(launches=launches, gather_dw=dw, linear_sum_assignment=lsa, step_ms=ms_med,
                step_gap=dw_gap, split_ms=split, peak_gb=peak_gb, cli_s=cli_s,
                work_dir=os.path.join(tmp, "bevfusion_train", "work"))


# ---------------------------------------------------------------------------
# BEVFusion stage 2: camera + lidar at full width (configs/bevfusion_cl.py)
# ---------------------------------------------------------------------------
CAMS, IMG_HW = 6, (256, 704)
CL_PREDICT_ITERS = 5
CL_TRAIN_ITERS = 3
CAMERA_TOL = 1e-4  # the camera map, card against the CPU on one geometry, of its scale: f32
# Swin, convs and bev_pool summed in other orders (cuDNN, cuBLAS, float atomics)
# the camera gradient's rounding floor may reach this share of its norm (8.95e-3 at full
# width on an H100: bev_pool's float atomics sum every run's camera map in another order,
# and the train-mode batch norms of the depth branch and the BEV downsample amplify it);
# the gradient against plain versions is held within twice the floor, as phase 18 does
CAMERA_FLOOR_MAX = 3e-2


def ring_camera_batch(clouds, seed: int) -> dict:
    """The camera keys of B frames as ReformatCamera makes them: the
    synthetic writer's 6 ring cameras (data/datasets/synthetic.py: at the ego
    origin, 1.6 m up), its 64 x 96 camera's intrinsics scaled to 704 wide
    (469 x 704 frames, bottom-cropped to 256 x 704 as ImageAug3D's val crop
    does), seeded images normalised as ImageNormalize does, and depth images
    rasterised from the B clouds by the port's ReformatCamera."""
    from dal3d_tpu_torch.data.pipelines.camera import ReformatCamera

    rng = np.random.RandomState(seed)
    s = IMG_HW[1] / 96.0
    crop = round(64 * s) - IMG_HW[0]
    K = np.array([[50 * s, 0.0, 48 * s], [0.0, 50 * s, 32 * s], [0.0, 0.0, 1.0]], np.float32)
    base = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    rots = []
    for ci in range(CAMS):
        c, sn = np.cos(2 * np.pi * ci / CAMS), np.sin(2 * np.pi * ci / CAMS)
        rots.append(np.array([[c, -sn, 0.0], [sn, c, 0.0], [0.0, 0.0, 1.0]]) @ base)
    mean = np.asarray((0.485, 0.456, 0.406), np.float32)
    std = np.asarray((0.229, 0.224, 0.225), np.float32)
    out = []
    for cloud in clouds:
        imgs = rng.randint(0, 256, (CAMS, *IMG_HW, 3)).astype(np.float32)
        cam = {"np_images": [((im / 255.0) - mean) / std for im in imgs],
               "camera_intrinsics": np.stack([K] * CAMS),
               "camera2lidar_rots": np.stack(rots).astype(np.float32),
               "camera2lidar_trans": np.tile(np.float32([0.0, 0.0, 1.6]), (CAMS, 1)),
               "aug_rots": [np.eye(2)] * CAMS, "aug_trans": [np.array([0.0, -crop])] * CAMS}
        res, _ = ReformatCamera(IMG_HW)({"camera": cam, "lidar": {"points": cloud}}, {})
        out.append(res["camera"]["batch"])
    return {k: np.stack([o[k] for o in out]) for k in out[0]}


def camera_stage_split(bundle, inputs, iters: int = 5) -> dict:
    """Host-clock split of one stage-2 predict with a synchronize after each
    stage (median of ``iters`` after one warm-up), the model's forward taken
    apart: lidar branch, Swin, FPN, depth branch + depthnet (with the depth x
    context outer product), splat (geometry + bev_pool), BEV downsample,
    fuser, decoder, head + decode."""
    from dal3d_tpu_torch.models.bevfusion import transfusion_decode
    from dal3d_tpu_torch.models.bevfusion.bevfusion import CAMERA_TRANSFORMS
    from dal3d_tpu_torch.models.bevfusion.vtransforms import depth_context, splat
    from dal3d_tpu_torch.ops.resize import resize_bilinear
    from dal3d_tpu_torch.runtime.bevfusion_steps import autotuned_convs

    model = bundle.model
    vt = model.camera_vtransform
    names = ["lidar", "Swin", "FPN", "depth branch + depthnet", "splat", "BEV downsample",
             "fuser", "decoder", "head + decode"]
    rec = {n: [] for n in names}
    imgs, dimg = inputs["images"], inputs["depth_images"]
    Bc, N = imgs.shape[:2]
    cam_args = [inputs[k] for k in CAMERA_TRANSFORMS]
    with torch.inference_mode(), autotuned_convs():
        for _ in range(iters + 1):
            marks = [time.perf_counter()]

            def mark():
                torch.cuda.synchronize()
                marks.append(time.perf_counter())

            lidar = model(inputs["vf"], inputs["vc"], inputs["vv"], "lidar")["lidar"]
            mark()
            stages = model.camera_backbone(imgs.reshape(Bc * N, *imgs.shape[2:]))
            mark()
            feat = model.camera_neck(stages)[0]
            mark()
            fH, fW = feat.shape[1:3]
            d = vt.dtransform(dimg.reshape(Bc * N, *dimg.shape[2:]).permute(0, 3, 1, 2))
            x = torch.cat([d, feat.permute(0, 3, 1, 2)], dim=1)
            ctx = depth_context(vt.depth_out(vt.depthnet(x)), vt.D).reshape(Bc, N, fH, fW, vt.D,
                                                                             vt.C)
            mark()
            bev = splat(ctx, cam_args, vt.image_size, *vt.bounds)
            del ctx
            mark()
            cam = vt.downsample(bev.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            if cam.shape[1:3] != lidar.shape[1:3]:  # not at full width: 180 x 180 both
                cam = resize_bilinear(cam, lidar.shape[1:3])
            mark()
            fused = model.fuser([cam, lidar])
            mark()
            dec = model.neck(model.decoder(fused))
            mark()
            transfusion_decode(model.head(dec), bundle.test_cfg)
            mark()
            for n, a, b_ in zip(names, marks[:-1], marks[1:]):
                rec[n].append((b_ - a) * 1e3)
    return {n: float(np.median(v[1:])) for n, v in rec.items()}


def window_attention_share(model, images, swin_ms: float) -> str:
    """Every window attention of one Swin forward (captured inputs): the
    modules' device ms (qkv, core, projection) against the whole Swin, and
    their cores beside ``scaled_dot_product_attention`` with the same bias +
    mask as its float mask (a yardstick only; the path runs the core)."""
    import torch.nn.functional as F

    from dal3d_tpu_torch.models.bevfusion.swin import WindowAttention

    calls = []
    mods = [m for m in model.camera_backbone.modules() if isinstance(m, WindowAttention)]
    hooks = [m.register_forward_hook(lambda mod, args, out: calls.append((mod, *args)))
             for m in mods]
    x = images.reshape(-1, *images.shape[2:])
    try:
        with torch.inference_mode():
            model.camera_backbone(x)
    finally:
        for h in hooks:
            h.remove()
    attn_ms = core_ms = sdpa_ms = err = 0.0
    with torch.inference_mode():
        for mod, a, mask in calls:
            attn_ms += cuda_time_ms(lambda: mod(a, mask), 3)
            nW, L, C = a.shape
            h = mod.num_heads
            qkv = mod.qkv(a).reshape(nW, L, 3, h, C // h).permute(2, 0, 3, 1, 4)
            q, k, v = (t.contiguous() for t in qkv)
            full = mod.bias()[None].expand(nW, h, L, L)
            if mask is not None:
                full = (full.reshape(-1, mask.shape[0], h, L, L) + mask[None, :, None]).reshape(
                    nW, h, L, L)
            full = full.contiguous()
            core_ms += cuda_time_ms(lambda: mod.core(q, k, v, mask), 3)
            sdpa_ms += cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k, v, full), 3)
            ref = mod.core(q, k, v, mask)
            got = F.scaled_dot_product_attention(q, k, v, full)
            err = max(err, float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30))
    return (f"{len(calls)} window attentions: {attn_ms:.2f} ms of the Swin's {swin_ms:.2f} ms "
            f"(share {attn_ms / swin_ms:.3f}); their cores (matmul + bias + mask + softmax + "
            f"matmul) {core_ms:.2f} ms, scaled_dot_product_attention with the same bias + mask "
            f"{sdpa_ms:.2f} ms (yardstick; within {err:.1e} of scale)")


def bev_pool_check(model, inputs) -> dict:
    """bev_pool's inputs captured from one camera forward: device ms against
    its bytes bound (features, coordinates and validity read once, the map
    written once), the card's map against the CPU's on the same
    coordinates, and the cells that differ on a repeat (float atomics)."""
    from dal3d_tpu_torch.models.bevfusion.bevfusion import CAMERA_TRANSFORMS
    from dal3d_tpu_torch.models.bevfusion import vtransforms as tvt
    from dal3d_tpu_torch.ops.bev_pool import bev_pool_batched

    with Capture(tvt, "bev_pool_batched") as cap, torch.inference_mode():
        model._camera(inputs["images"], inputs["depth_images"],
                      [inputs[k] for k in CAMERA_TRANSFORMS])
    feats, coords, valid, nx, ny, nz = cap.calls[0]
    with torch.inference_mode():
        a = bev_pool_batched(feats, coords, valid, nx, ny, nz)
        b_ = bev_pool_batched(feats, coords, valid, nx, ny, nz)
        ms = cuda_time_ms(lambda: bev_pool_batched(feats, coords, valid, nx, ny, nz), 5)
    repeat_cells = int((a != b_).any(-1).sum())
    cpu = bev_pool_batched(feats.cpu(), coords.cpu(), valid.cpu(), nx, ny, nz)
    rel = float((a.cpu() - cpu).abs().max()) / max(float(cpu.abs().max()), 1e-30)
    nbytes = (feats.numel() * feats.element_size() + coords.numel() * coords.element_size()
              + valid.numel() * valid.element_size() + a.numel() * a.element_size())
    bound = nbytes / PEAK_BYTES * 1e3
    if not rel <= 1e-5:
        fail(f"bev_pool card vs CPU: {rel:.2e} of scale > 1e-5")
    print(f"splat (bev_pool): features {tuple(feats.shape)} ({feats.numel() * 4 / 1e9:.3f} GB) "
          f"into [{B}, {ny}, {nx}, {nz * feats.shape[-1]}], {int(valid.sum())} of {valid.numel()} "
          f"points in the grid: {ms:.3f} ms on the card against its bytes bound {bound:.3f} ms "
          f"({nbytes / 1e9:.3f} GB at {PEAK_BYTES / 1e12:.2f} TB/s; {bound / ms:.2f} of it); card "
          f"vs CPU on the same coordinates {rel:.1e} of scale (tol 1e-5); a repeat on the card "
          f"differs in {repeat_cells} of {ny * nx * B} cells (float atomics)")
    return dict(ms=ms, bound_ms=bound, repeat_cells=repeat_cells, cpu_rel=rel)


def camera_card_vs_cpu(bundle, inputs) -> str:
    """The camera branch (Swin -> FPN -> DepthLSSTransform) on the card
    against a CPU copy of it on the same inputs, f32. The frustum geometry
    is counted apart (the points whose cell differs between the card's and
    the CPU's: cuSOLVER's and LAPACK's 3x3 inverses round differently), then
    both run on the card's geometry, held within CAMERA_TOL of the map's
    scale."""
    from dal3d_tpu_torch.models.bevfusion.bevfusion import CAMERA_TRANSFORMS
    import copy

    from dal3d_tpu_torch.models.bevfusion import vtransforms as tvt

    model = bundle.model
    vt = model.camera_vtransform
    cpu = copy.deepcopy(model.camera_backbone).cpu(), copy.deepcopy(
        model.camera_neck).cpu(), copy.deepcopy(vt).cpu()
    cam_args = [inputs[k] for k in CAMERA_TRANSFORMS]
    fH, fW = IMG_HW[0] // 8, IMG_HW[1] // 8
    fr = torch.from_numpy(tvt.create_frustum(IMG_HW, (fH, fW), vt.bounds[0])).permute(1, 2, 0, 3)
    geom = tvt.get_geometry(fr.to(bundle.device), *cam_args)
    geom_cpu = tvt.get_geometry(fr, *[a.cpu() for a in cam_args])
    dx, bx, _ = tvt.gen_dx_bx(*vt.bounds[1:])
    lo, step = torch.from_numpy(bx - dx / 2), torch.from_numpy(dx)
    flips = int((torch.floor((geom.cpu() - lo) / step) != torch.floor((geom_cpu - lo) / step))
                .any(-1).sum())

    def branch(mods, imgs, dimg, args):
        backbone, neck, vtr = mods
        Bc, N = imgs.shape[:2]
        f = neck(backbone(imgs.reshape(Bc * N, *imgs.shape[2:])))[0]
        return vtr(f.reshape(Bc, N, *f.shape[1:]), dimg, *args)

    with mock.patch.object(tvt, "get_geometry", lambda frustum, *a: geom.to(frustum.device)), \
            torch.inference_mode():
        card = branch((model.camera_backbone, model.camera_neck, vt), inputs["images"],
                      inputs["depth_images"], cam_args).cpu()
        t0 = time.perf_counter()
        ref = branch(cpu, inputs["images"].cpu(), inputs["depth_images"].cpu(),
                     [a.cpu() for a in cam_args])
        cpu_s = time.perf_counter() - t0
    rel = float((card - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
    if not rel <= CAMERA_TOL:
        fail(f"camera branch card vs CPU: {rel:.2e} of scale > {CAMERA_TOL:g}")
    return (f"camera map {tuple(card.shape)} within {rel:.1e} of scale (tol {CAMERA_TOL:g}) on "
            f"the card's geometry ({cpu_s:.1f} s on the CPU); the two geometries put {flips} of "
            f"{geom.shape[:-1].numel()} frustum points in another cell")


def swin_t_state_dict(rng) -> dict:
    """Seeded microsoft / timm-named Swin-T weights (the pretrained
    swint-nuimages checkpoint's names and shapes), as
    tests/test_swin_convert.py builds them."""
    def r(*shape):
        return (0.05 * rng.randn(*shape)).astype(np.float32)

    sd = {"patch_embed.proj.weight": r(96, 3, 4, 4), "patch_embed.proj.bias": r(96),
          "patch_embed.norm.weight": 1 + r(96), "patch_embed.norm.bias": r(96)}
    dim = 96
    for i, (depth, heads) in enumerate(zip((2, 2, 6, 2), (3, 6, 12, 24))):
        for j in range(depth):
            t = f"layers.{i}.blocks.{j}."
            sd.update({t + "norm1.weight": 1 + r(dim), t + "norm1.bias": r(dim),
                       t + "attn.qkv.weight": r(3 * dim, dim), t + "attn.qkv.bias": r(3 * dim),
                       t + "attn.relative_position_bias_table": r(169, heads),
                       t + "attn.relative_position_index": np.zeros((49, 49), np.int64),
                       t + "attn.proj.weight": r(dim, dim), t + "attn.proj.bias": r(dim),
                       t + "norm2.weight": 1 + r(dim), t + "norm2.bias": r(dim),
                       t + "mlp.fc1.weight": r(4 * dim, dim), t + "mlp.fc1.bias": r(4 * dim),
                       t + "mlp.fc2.weight": r(dim, 4 * dim), t + "mlp.fc2.bias": r(dim)})
        if i < 3:
            t = f"layers.{i}.downsample."
            sd.update({t + "norm.weight": 1 + r(4 * dim), t + "norm.bias": r(4 * dim),
                       t + "reduction.weight": r(2 * dim, 4 * dim)})
        if i > 0:
            sd.update({f"norm{i}.weight": 1 + r(dim), f"norm{i}.bias": r(dim)})
        dim *= 2
    return sd


def write_stage2_config(path: str, root: str, info: str, work_dir: str) -> None:
    """configs/bevfusion_cl.py with its stage-1 base (configs/bevfusion_lidar.py)
    written in place of the import, pointed at a synthetic camera set, a log
    line every step."""
    base = open(os.path.join(ROOT, "configs", "bevfusion_lidar.py")).read()
    cl = open(os.path.join(ROOT, "configs", "bevfusion_cl.py")).read()
    line = "from bevfusion_lidar import *  # noqa: F401,F403"
    if line not in cl:
        fail(f"configs/bevfusion_cl.py no longer imports its base as {line!r}")
    with open(path, "w") as f:
        f.write(cl.replace(line, base))
        f.write(f"\ndata['train'].update(root_path={root!r}, info_path={info!r})\n"
                f"work_dir = {work_dir!r}\nlog_config = dict(interval=1)\n")


def camera_train_cli(tmp: str, stage1_work: str) -> dict:
    """train_bevfusion with the stage-2 config on a synthetic camera set
    (4 frames, 6 ring cameras of 900 x 1600 JPEGs each) through the port's
    camera pipeline: --load_from the stage-1 work dir and --swin_init of a
    seeded torch-named Swin-T through tools/convert_swin.py, an epoch, then
    --resume_from for a second. Returns seconds per run."""
    from dal3d_tpu_torch.data.datasets.synthetic import make_synthetic_nuscenes
    from dal3d_tpu_torch.runtime import checkpoint as ckpt
    from dal3d_tpu_torch.tools import convert_swin, train_bevfusion

    base = os.path.join(tmp, "stage2_cli")
    os.makedirs(base)
    t0 = time.perf_counter()
    info = make_synthetic_nuscenes(os.path.join(base, "data"), n_frames=4, n_logs=1,
                                   points_per_frame=20000, seed=19, with_camera=True,
                                   image_hw=(900, 1600))
    data_s = time.perf_counter() - t0
    cfg, work = os.path.join(base, "bevfusion_cl.py"), os.path.join(base, "work")
    write_stage2_config(cfg, os.path.join(base, "data"), info, work)
    pth, npz = os.path.join(base, "swint.pth"), os.path.join(base, "swint.npz")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                               swin_t_state_dict(np.random.RandomState(19)).items()}}, pth)
    t0 = time.perf_counter()
    flat = convert_swin.main([pth, npz])
    seconds = {"convert_swin": time.perf_counter() - t0}

    def run(tag, argv):
        t0 = time.perf_counter()
        out = train_bevfusion.main(argv)
        torch.cuda.synchronize()
        seconds[tag] = time.perf_counter() - t0
        return out

    r1 = run("epoch (--load_from, --swin_init)",
             [cfg, "--epochs", "1", "--load_from", stage1_work, "--swin_init", npz])
    n1 = r1["optimizer"].count
    log = open(os.path.join(work, "train.log")).read()
    copied = int(log.split("partial warm-start from ")[1].split(": ")[1].split(" ")[0])
    if (ckpt.latest_epoch(work) != 1 or n1 < 1 or copied <= 0
            or f"camera backbone initialised from {npz} ({len(flat)} tensors)" not in log
            or not all(np.isfinite(v) for v in r1["logs"].values())):
        fail(f"train_bevfusion stage 2: epoch {ckpt.latest_epoch(work)}, {n1} steps, {copied} "
             f"tensors from stage 1, logs {r1['logs']}")
    del r1
    r2 = run("--resume_from", [cfg, "--epochs", "2", "--resume_from", work])
    if ckpt.latest_epoch(work) != 2 or r2["optimizer"].count != 2 * n1:
        fail(f"train_bevfusion stage 2 --resume_from: epoch {ckpt.latest_epoch(work)}, step "
             f"{r2['optimizer'].count} (expected {2 * n1})")
    del r2
    print(f"  train_bevfusion stage 2 CLI ({n1} steps an epoch on 4 synthetic camera frames, "
          f"written in {data_s:.1f} s): " + "; ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
          + f"; --load_from copied {copied} tensors of the stage-1 work dir, --swin_init "
          f"{len(flat)} converted Swin-T arrays")
    return seconds


def camera_lidar_phase(tmp: str, Config, counters, tg, tl, stage1_work: str) -> dict:
    """Phase 19: BEVFusion stage 2 (configs/bevfusion_cl.py) at full width.
    Returns each kernel's launches over the predict and the train step main
    paths, and the phase's numbers."""
    from dal3d_tpu_torch.models.builder import bevfusion_optimizer, build_bevfusion
    from dal3d_tpu_torch.runtime.bevfusion_steps import (bevfusion_inputs,
                                                         make_bevfusion_predict_step,
                                                         make_bevfusion_train_step)
    from dal3d_tpu_torch.runtime.steps import _to_device

    t_phase = time.perf_counter()
    cfg = Config.fromfile(os.path.join(ROOT, "configs", "bevfusion_cl.py"))
    batch, occupied, _ = bevfusion_batch(10, cfg)
    t0 = time.perf_counter()
    batch.update(ring_camera_batch(bevfusion_clouds(10), 19))
    cam_s = time.perf_counter() - t0
    bundle = build_bevfusion(cfg, seed=0)
    model, dev = bundle.model, bundle.device
    n_cam = sum(p.numel() for n, p in model.named_parameters() if n.startswith("camera_"))
    print(f"stage-2 inputs: phase 14's clouds ({occupied} occupied voxels), {CAMS} ring cameras "
          f"at {IMG_HW[0]}x{IMG_HW[1]} per frame, depth images rasterised from the clouds "
          f"({int((batch['depth_images'] > 0).sum())} pixels hit; {cam_s:.1f} s on the host); "
          f"model {sum(p.numel() for p in model.parameters())} parameters, {n_cam} in the camera "
          f"branch (Swin-T, LSS FPN, DepthLSSTransform D {model.camera_vtransform.D} C "
          f"{model.camera_vtransform.C}), fuser {tuple(model.fuser.fuse.conv.weight.shape)}")

    # the predict main path
    predict = make_bevfusion_predict_step(bundle)
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = predict(batch)  # warm-up: cuDNN's autotuner tries its algorithms
    torch.cuda.synchronize()
    peak_first = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(CL_PREDICT_ITERS):
        t0 = time.perf_counter()
        out = predict(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    n_runs = CL_PREDICT_ITERS + 1
    launches_p = {c.__name__: c.launches for c in counters}
    peak_p = torch.cuda.max_memory_allocated() / 1e9
    want = {n: 0 for n in launches_p}
    want.update(gather_gemm=K4_PER_PREDICT * n_runs, gather_rows=K5_PER_PREDICT * n_runs)
    if launches_p != want:
        fail(f"stage-2 predict launched {launches_p} in {n_runs} predicts; expected {want}")
    for k, shp in {"box3d_lidar": (B, 200, 9), "scores": (B, 200), "bev_feat": (B, 180, 180, 512)
                   }.items():
        if tuple(out[k].shape) != shp or not bool(torch.isfinite(out[k]).all()):
            fail(f"stage-2 predict output {k}: shape {tuple(out[k].shape)}, finite "
                 f"{bool(torch.isfinite(out[k]).all())}")
    n_det = [int(x) for x in out["det_valid"].sum(1)]
    if min(n_det) == 0:
        fail(f"stage-2 predict: no detections {n_det}")
    pred_ms = float(np.median(times))
    print(f"stage-2 predict (B={B}, {CAMS} cameras): median {pred_ms:.2f} ms, mean "
          f"{np.mean(times):.2f} ms, min {min(times):.2f} ms over {CL_PREDICT_ITERS}; peak memory "
          f"{peak_p:.2f} GB ({peak_first:.2f} GB in the first predict, cuDNN's autotuner "
          f"included); detections {n_det}; launches gather_gemm "
          f"{launches_p['gather_gemm']} gather_rows {launches_p['gather_rows']} in {n_runs} "
          "predicts, no other kernel")
    inputs = bevfusion_inputs(model, batch, dev)
    split = camera_stage_split(bundle, inputs)
    print("stage-2 predict split (ms, median of 5, synchronized per stage): "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    prof_p = device_profile(lambda: predict(batch), "stage-2 predict", pred_ms)
    for tag, key in (("K4", "gather_gemm_kernel"), ("K5", "gather_rows_kernel")):
        print(f"  profile: {tag} {sum(v[0] for k, v in prof_p.items() if key in k):.3f} ms a "
              "predict")
    pool = bev_pool_check(model, inputs)
    print(f"window attention: {window_attention_share(model, inputs['images'], split['Swin'])}")
    print(f"stage-2 main path vs the same path on plain versions: "
          f"{bevfusion_plain_check(bundle, batch, tg, maps=('camera', 'fused', 'decoder'))}")
    print(f"stage-2 camera branch, card vs CPU: {camera_card_vs_cpu(bundle, inputs)}")

    # the train step: the camera parameters' gradient against plain versions
    gt = (_to_device(bevfusion_gt(18)[0], dev, torch.float32),
          _to_device(bevfusion_gt(18)[1], dev, torch.int32))
    logs_k, g_k, rk = step_gradients(bundle, inputs, gt, 0, False, tg, tl)
    logs_p, g_p, _ = step_gradients(bundle, inputs, gt, 0, True, tg, tl, queries=rk["queries"],
                                    assignment=rk["col4row"])
    gen = torch.Generator().manual_seed(19)
    moved = dict(inputs, vf=inputs["vf"] * (1.0 + 1e-7 * torch.randn(
        inputs["vf"].shape, generator=gen)).to(dev), images=inputs["images"] * (
        1.0 + 1e-7 * torch.randn(inputs["images"].shape, generator=gen)).to(dev))
    _, g_n, _ = step_gradients(bundle, moved, gt, 0, True, tg, tl, queries=rk["queries"],
                               assignment=rk["col4row"])
    cam_names = [n for n in g_k if n.startswith("camera_")]
    gap = _grad_gap({n: g_p[n] for n in cam_names}, {n: g_k[n] for n in cam_names})
    floor = _grad_gap({n: g_p[n] for n in cam_names}, {n: g_n[n] for n in cam_names})
    all_gap = _grad_gap(g_p, g_k)
    tol = max(STEP_TOL, 2 * floor)
    log_gap = max(abs(float(logs_k[k]) - float(logs_p[k])) / max(abs(float(logs_p[k])), 1e-30)
                  for k in ("loss", "cls_loss", "reg_loss", "heatmap_loss"))
    swin_g = float(g_k["camera_backbone.patch_embed.proj.weight"].abs().max())
    if not (gap <= tol and floor <= CAMERA_FLOOR_MAX and swin_g > 0 and log_gap <= 1e-4):
        fail(f"stage-2 train step vs plain versions: camera gradient gap {gap:.2e} (tol "
             f"{tol:.2e}; rounding floor {floor:.2e}), Swin's first gradient max {swin_g:.2e}, "
             f"logs gap {log_gap:.2e}")
    print(f"stage-2 train step vs the same step on plain versions (the kernel run's queries and "
          f"matching, the same stochastic depth): the camera branch's gradient ({len(cam_names)} "
          f"tensors) within {gap:.2e} of its norm (tol {tol:.2e}; rounding alone, the plain step "
          f"on voxel features and images moved by about one ulp, opens {floor:.2e}); the whole "
          f"gradient within {all_gap:.2e}; loss and its parts within {log_gap:.1e}")
    del g_k, g_p, g_n

    # the train step main path
    train = dict(batch, gt_boxes=bevfusion_gt(18)[0], gt_classes=bevfusion_gt(18)[1])
    opt = bevfusion_optimizer(cfg, bundle, 100)
    step = make_bevfusion_train_step(bundle, opt)
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    step(train)
    torch.cuda.synchronize()
    peak_first_t = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(CL_TRAIN_ITERS):
        t0 = time.perf_counter()
        logs = {k: float(v) for k, v in step(train).items()}
        times.append((time.perf_counter() - t0) * 1e3)
    n_steps = CL_TRAIN_ITERS + 1
    launches_t = {c.__name__: c.launches for c in counters}
    peak_t = torch.cuda.max_memory_allocated() / 1e9
    want = {n: 0 for n in launches_t}
    want.update(gather_gemm=K4_PER_BF_TRAIN_STEP * n_steps,
                gather_dw=K4_DW_PER_BF_TRAIN_STEP * n_steps,
                gather_rows=K5_PER_BF_TRAIN_STEP * n_steps,
                linear_sum_assignment=LSA_PER_BF_TRAIN_STEP * n_steps)
    if launches_t != want:
        fail(f"stage-2 train main path launched {launches_t} in {n_steps} steps; expected {want}")
    if not all(np.isfinite(v) for v in logs.values()) or logs["num_matched"] != sum(BF_GT):
        fail(f"stage-2 train step logs {logs}")
    step_ms = float(np.median(times))
    print(f"stage-2 train step (B={B}, f32): median {step_ms:.2f} ms, mean {np.mean(times):.2f} "
          f"ms over {CL_TRAIN_ITERS} steps; peak memory {peak_t:.2f} GB ({peak_first_t:.2f} GB in "
          f"the first step, cuDNN's autotuner included); launches per step: "
          f"gather_gemm {launches_t['gather_gemm'] // n_steps}, gather_dw "
          f"{launches_t['gather_dw'] // n_steps}, gather_rows "
          f"{launches_t['gather_rows'] // n_steps}, linear_sum_assignment "
          f"{launches_t['linear_sum_assignment'] // n_steps}, no other kernel; logs {logs}")
    tsplit = bevfusion_train_split(bundle, opt, inputs, gt, 3)
    print("stage-2 train step split (ms, median of 3, synchronized per part): "
          + ", ".join(f"{k} {v:.2f}" for k, v in tsplit.items()))
    device_profile(lambda: step(train), "stage-2 train step", step_ms)
    del step, opt, predict, bundle, model, inputs
    torch.cuda.empty_cache()

    # the CLI: stage 2 from phase 18's stage-1 work dir
    cli_s = camera_train_cli(tmp, stage1_work)
    print(f"phase 19 (BEVFusion stage 2): {time.perf_counter() - t_phase:.1f} s")
    return dict(launches_predict=launches_p, launches_train=launches_t, predict_ms=pred_ms,
                step_ms=step_ms, split_ms=split, peak_gb=(peak_p, peak_t),
                train_split_ms=tsplit, bev_pool=pool,
                camera_gap=gap, camera_floor=floor, cli_s=cli_s)


# ---------------------------------------------------------------------------
# launches of a path, each against its kernel's plain version
# ---------------------------------------------------------------------------
def hold_launches(tag: str, k4=(), dw=(), k5=(), lsa=(), k2=()) -> dict:
    """Every captured launch of a path against its kernel's plain version on
    the same inputs: K4 (``_launch_gemm``: forward and input gradient) within
    K4_TOL of scale over its plan, K4-dW within DW_TOL, K5 and LSA bit-equal,
    K2 within 1e-5. Returns {kernel: (launches, max error relative to
    scale)}."""
    from dal3d_tpu_torch.ops import gather as tg
    from dal3d_tpu_torch.ops import iou_matrix as tiou
    from dal3d_tpu_torch.ops import lsa as tl

    def rel(got, ref):
        return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)

    out = {}
    with torch.no_grad():
        errs = [rel(tg._launch_gemm(f, p, w), gemm_plain_over_plan(tg, f, p, w))
                for f, p, w in k4]
        if max(errs, default=0.0) > K4_TOL:
            fail(f"{tag}: a K4 launch {max(errs):.2e} of scale from its plain version")
        out["gather_gemm"] = (len(errs), max(errs, default=0.0))
        errs = [rel(tg._launch_dw(f, p, g), dw_plain_over_plan(tg, f, p, g)) for f, p, g in dw]
        if max(errs, default=0.0) > DW_TOL:
            fail(f"{tag}: a K4-dW launch {max(errs):.2e} of scale from its plain version")
        out["gather_dw"] = (len(errs), max(errs, default=0.0))
        for table, idx in k5:
            if not torch.equal(tg.gather_rows(table, idx), tg.gather_rows_plain(table, idx)):
                fail(f"{tag}: a K5 launch differs from its plain version")
        out["gather_rows"] = (len(k5), 0.0)
        for (cost,) in lsa:
            if not torch.equal(tl.linear_sum_assignment(cost),
                               tl.linear_sum_assignment_plain(cost)):
                fail(f"{tag}: an LSA launch's col4row differs from its plain version's")
        out["linear_sum_assignment"] = (len(lsa), 0.0)
        errs = [float((tiou.iou_matrix(r, c) - tiou.iou_matrix_plain(r, c)).abs().max())
                for r, c in k2]
        if max(errs, default=0.0) > 1e-5:
            fail(f"{tag}: a K2 launch {max(errs):.2e} from its plain version")
        out["iou_matrix"] = (len(errs), max(errs, default=0.0))
    print(f"{tag}: every launch against its plain version: "
          + ", ".join(f"{k} {n} within {e:.1e}" for k, (n, e) in out.items() if n))
    return out


def main_path_launches(counters, tag: str, runs: int, per_run: dict) -> dict:
    """The counters after ``runs`` runs of a main path, held to ``per_run``
    launches of each kernel a run (every other kernel none)."""
    launches = {c.__name__: c.launches for c in counters}
    want = {n: per_run.get(n, 0) * runs for n in launches}
    if launches != want:
        fail(f"{tag} launched {launches} in {runs} runs; expected {want}")
    return launches


# ---------------------------------------------------------------------------
# phase 20: BEVFusion's map segmentation and CenterPoint heads (A10.c)
# ---------------------------------------------------------------------------
SEG_BOUND = (-50.0, 50.0, 0.5)  # the reference's map grid: 200 x 200 cells
SEG_ITERS = 3
CENTER_TOL = 1e-5  # the centre heatmaps, of their scale; the centre loss, relative
CENTER_ITERS = 3
# nuScenes classes 1..10 -> (task, task-local 1-based class) of the CenterPoint
# task groups (car), (truck, construction_vehicle), (bus, trailer), (barrier),
# (motorcycle, bicycle), (pedestrian, traffic_cone)
CENTER_TASKS = (1, 2, 2, 1, 2, 2)


def map_targets(n: int) -> np.ndarray:
    """[n, 200, 200, 6] f32 map targets from the port's LoadBEVSegmentation
    on the reference's grid (the synthetic map, at n ego poses), transposed
    as ReformatFixedShape does."""
    from dal3d_tpu_torch.data.pipelines.bev_seg import LoadBEVSegmentation

    stage = LoadBEVSegmentation(SEG_BOUND, SEG_BOUND)
    out = []
    for b in range(n):
        car_from_global = np.eye(4)
        car_from_global[:3, 3] = [-7.0 - 30.0 * b, -13.0 - 100.0 * b, 0.0]
        res, _ = stage({"lidar": {"aug_matrix": np.eye(3, dtype=np.float32)}},
                       {"car_from_global": car_from_global, "ref_from_car": np.eye(4)})
        out.append(res["gt_masks_bev"].transpose(2, 1, 0))
    return np.stack(out).astype(np.float32)


def center_gt(seed: int, dev) -> tuple:
    """bevfusion_gt's boxes split into the CenterPoint task groups: lists
    per task of [B, 200, 9] boxes and [B, 200] task-local 1-based classes."""
    boxes, classes = bevfusion_gt(seed)
    first = np.cumsum((0,) + CENTER_TASKS)
    gb, gc = [], []
    for t, nc in enumerate(CENTER_TASKS):
        keep = (classes > first[t]) & (classes <= first[t] + nc)
        gc.append(torch.from_numpy(np.where(keep, classes - first[t], 0).astype(np.int32)).to(dev))
        gb.append(torch.from_numpy(boxes).to(dev))
    return gb, gc


def center_topk(preds, cfg) -> list:
    """The flat (pixel, class) indices center_head_decode takes per task, in
    its order ([B, max_per_task] each)."""
    import torch.nn.functional as F

    from dal3d_tpu_torch.ops.nms import top_k

    out = []
    for p in preds:
        Bp, H, W, nc = p["heatmap"].shape
        prob = torch.sigmoid(p["heatmap"].permute(0, 3, 1, 2))
        peaks = torch.where(prob == F.max_pool2d(prob, 3, 1, 1), prob, torch.zeros_like(prob))
        out.append(top_k(peaks.permute(0, 2, 3, 1).reshape(Bp, -1), cfg.max_per_task)[1])
    return out


def center_gradients(bundle, inputs, gt, plain: bool, tg) -> tuple:
    """The CenterPoint model's train-mode forward, center_head_loss and
    backward, with the kernels or on plain versions; the running statistics
    are put back. Returns (loss, {name: grad})."""
    from dal3d_tpu_torch.models.bevfusion.centerpoint import center_head_loss
    from dal3d_tpu_torch.runtime.bevfusion_steps import autotuned_convs

    model = bundle.model
    model.train()
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    model.zero_grad(set_to_none=True)
    saved = tg.gather_gemm
    if plain:
        tg.gather_gemm = lambda f, idx, hit, w, plan=None: tg.gather_gemm_plain(f, idx, hit, w)
    try:
        with autotuned_convs():
            preds = model(inputs["vf"].float(), inputs["vc"], inputs["vv"])["center_preds"]
            loss = center_head_loss(preds, *gt, bundle.test_cfg)["loss"]
            loss.backward()
        torch.cuda.synchronize()
    finally:
        tg.gather_gemm = saved
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k in stats:
                v.copy_(stats[k])
    model.eval()
    return float(loss.detach()), grads


def map_seg_cli(tmp: str) -> dict:
    """train_bevfusion on configs/bevfusion_cl_synthetic.py as written (map
    segmentation, camera + lidar) in a directory holding a 4-frame synthetic
    camera set at the config's relative paths: an epoch, then --resume_from
    for a second. Returns seconds per run and the logged seg losses."""
    import re

    from dal3d_tpu_torch.data.datasets.synthetic import make_synthetic_nuscenes
    from dal3d_tpu_torch.runtime import checkpoint as ckpt
    from dal3d_tpu_torch.tools import train_bevfusion

    base = os.path.join(tmp, "map_seg_cli")
    os.makedirs(base)
    cfg = os.path.join(ROOT, "configs", "bevfusion_cl_synthetic.py")
    cwd = os.getcwd()
    os.chdir(base)
    try:
        make_synthetic_nuscenes("data/synthetic_cam", n_frames=4, n_logs=1,
                                points_per_frame=3000, range_xy=7.0, max_boxes=6, seed=20,
                                with_camera=True, image_hw=(64, 96),
                                classes=["car", "pedestrian", "traffic_cone"])
        seconds = {}
        t0 = time.perf_counter()
        r1 = train_bevfusion.main([cfg])
        seconds["epoch"] = time.perf_counter() - t0
        n1, work = r1["optimizer"].count, "work_dirs/bevfusion_cl_synthetic"
        t0 = time.perf_counter()
        r2 = train_bevfusion.main([cfg, "--epochs", "2", "--resume_from", work])
        seconds["--resume_from"] = time.perf_counter() - t0
        log = open(os.path.join(work, "train.log")).read()
    finally:
        os.chdir(cwd)
    seg = [float(x) for x in re.findall(r" seg ([0-9.naif]+)\)", log)]
    if (r1["bundle"].model.seg_head is None or r2["optimizer"].count != 2 * n1
            or ckpt.latest_epoch(os.path.join(base, work)) != 2 or not seg
            or not all(np.isfinite(x) and x > 0 for x in seg)
            or not np.isfinite(r2["logs"]["seg_loss"]) or not r2["logs"]["seg_loss"] > 0):
        fail(f"train_bevfusion on bevfusion_cl_synthetic.py: steps {n1} / "
             f"{r2['optimizer'].count}, logged seg losses {seg}, last logs {r2['logs']}")
    print(f"  train_bevfusion on configs/bevfusion_cl_synthetic.py as written ({n1} steps an "
          f"epoch on 4 synthetic camera frames): " + "; ".join(
              f"{k} {v:.1f} s" for k, v in seconds.items())
          + f"; seg losses logged {', '.join(f'{x:.4f}' for x in seg)}")
    return dict(seconds=seconds, seg_losses=seg)


def other_heads_phase(tmp: str, Config, counters, tg, tl) -> dict:
    """Phase 20: the map-segmentation head on the stage-2 model and the
    CenterPoint head on the lidar-only model, at full width, B=2, and the
    map-segmentation CLI. Returns each kernel's launches over the three main
    paths (seg predict, seg train step, CenterPoint) and the numbers."""
    from dal3d_tpu_torch.models.bevfusion.centerpoint import center_head_decode
    from dal3d_tpu_torch.models.builder import bevfusion_optimizer, build_bevfusion
    from dal3d_tpu_torch.runtime.bevfusion_steps import (autotuned_convs, bevfusion_inputs,
                                                         make_bevfusion_predict_step,
                                                         make_bevfusion_train_step)
    from dal3d_tpu_torch.runtime.steps import _to_device

    t_phase = time.perf_counter()
    # -- map segmentation: configs/bevfusion_cl.py with with_map_seg
    cfg = Config.fromfile(os.path.join(ROOT, "configs", "bevfusion_cl.py"))
    cfg["model"] = dict(cfg["model"], with_map_seg=True)
    batch, _, _ = bevfusion_batch(10, cfg)
    batch.update(ring_camera_batch(bevfusion_clouds(10), 19))
    masks = map_targets(B)
    bundle = build_bevfusion(cfg, seed=0)
    model, dev = bundle.model, bundle.device
    print(f"map segmentation: stage-2 model + BEVSegmentationHead ({len(model.seg_head.classes)} "
          f"classes, {sum(p.numel() for p in model.seg_head.parameters())} parameters) on the "
          f"180 x 180 neck map; targets from LoadBEVSegmentation on the {masks.shape[1]} x "
          f"{masks.shape[2]} reference grid (cells set per class "
          f"{masks.reshape(-1, masks.shape[-1]).mean(0).round(3).tolist()})")
    predict = make_bevfusion_predict_step(bundle)
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = predict(batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(SEG_ITERS):
        t0 = time.perf_counter()
        out = predict(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches_sp = main_path_launches(counters, "map-seg predict", SEG_ITERS + 1,
                                     dict(gather_gemm=K4_PER_PREDICT, gather_rows=K5_PER_PREDICT))
    peak_sp = torch.cuda.max_memory_allocated() / 1e9
    seg = out["seg_logits"]
    if tuple(seg.shape) != (B, 180, 180, 6) or not bool(torch.isfinite(seg).all()):
        fail(f"map-seg predict: seg_logits {tuple(seg.shape)}, finite "
             f"{bool(torch.isfinite(seg).all())}")
    sp_ms = float(np.median(times))
    kern = (tg.gather_gemm, tg.gather_rows)
    plain = (lambda f, idx, hit, w, plan=None: tg.gather_gemm_plain(f, idx, hit, w),
             tg.gather_rows_plain)
    pk, pp = (bevfusion_forward(bundle, batch, tg, *w)[0] for w in (kern, plain))
    seg_err = {k: float((pk[k] - pp[k]).abs().max()) / max(float(pp[k].abs().max()), 1e-30)
               for k in ("seg_logits", "bev_feat")}
    if max(seg_err.values()) > BF_TOL:
        fail(f"map-seg predict vs plain versions: {seg_err} of scale > {BF_TOL:g}")
    del pk, pp
    print(f"map-seg predict (B={B}): median {sp_ms:.2f} ms over {SEG_ITERS}; peak memory "
          f"{peak_sp:.2f} GB; launches {launches_sp['gather_gemm']} K4, "
          f"{launches_sp['gather_rows']} K5 in {SEG_ITERS + 1} predicts; seg_logits "
          f"{seg_err['seg_logits']:.1e} and the neck map {seg_err['bev_feat']:.1e} of scale from "
          f"the same forward on plain versions (tol {BF_TOL:g})")
    device_profile(lambda: predict(batch), "map-seg predict", sp_ms)

    inputs = bevfusion_inputs(model, batch, dev)
    gt = (_to_device(bevfusion_gt(18)[0], dev, torch.float32),
          _to_device(bevfusion_gt(18)[1], dev, torch.int32))
    seg_t = _to_device(masks, dev, torch.float32)
    logs_k, g_k, rk = step_gradients(bundle, inputs, gt, 0, False, tg, tl, seg=seg_t)
    logs_p, g_p, _ = step_gradients(bundle, inputs, gt, 0, True, tg, tl, queries=rk["queries"],
                                    assignment=rk["col4row"], seg=seg_t)
    gen = torch.Generator().manual_seed(20)
    moved = dict(inputs, vf=inputs["vf"] * (1.0 + 1e-7 * torch.randn(
        inputs["vf"].shape, generator=gen)).to(dev), images=inputs["images"] * (
        1.0 + 1e-7 * torch.randn(inputs["images"].shape, generator=gen)).to(dev))
    _, g_n, _ = step_gradients(bundle, moved, gt, 0, True, tg, tl, queries=rk["queries"],
                               assignment=rk["col4row"], seg=seg_t)
    gap, floor = _grad_gap(g_p, g_k), _grad_gap(g_p, g_n)
    names = [n for n in g_k if n.startswith("seg_head.")]
    seg_gap = _grad_gap({n: g_p[n] for n in names}, {n: g_k[n] for n in names})
    seg_floor = _grad_gap({n: g_p[n] for n in names}, {n: g_n[n] for n in names})
    tol, seg_tol = max(STEP_TOL, 2 * floor), max(STEP_TOL, 2 * seg_floor)
    log_gap = max(abs(float(logs_k[k]) - float(logs_p[k])) / max(abs(float(logs_p[k])), 1e-30)
                  for k in ("loss", "seg_loss", "cls_loss", "reg_loss", "heatmap_loss"))
    if not (gap <= tol and seg_gap <= seg_tol and max(floor, seg_floor) <= CAMERA_FLOOR_MAX
            and log_gap <= 1e-4 and float(logs_k["seg_loss"]) > 0
            and float(g_k["seg_head.out.weight"].abs().max()) > 0):
        fail(f"map-seg train step vs plain versions: gradient gap {gap:.2e} (tol {tol:.2e}), "
             f"the seg head's {seg_gap:.2e} (tol {seg_tol:.2e}), logs gap {log_gap:.2e}, "
             f"seg_loss {float(logs_k['seg_loss'])}")
    print(f"map-seg train step vs the same step on plain versions (the kernel run's queries and "
          f"matching): gradient within {gap:.2e} of its norm (tol {tol:.2e}; rounding alone "
          f"opens {floor:.2e}), the seg head's within {seg_gap:.2e} (tol {seg_tol:.2e}); loss "
          f"and seg_loss within {log_gap:.1e} (seg_loss {float(logs_k['seg_loss']):.4f}, the "
          f"180 x 180 logits resized to the 200 x 200 targets)")
    del g_k, g_p, g_n

    train = dict(batch, gt_boxes=bevfusion_gt(18)[0], gt_classes=bevfusion_gt(18)[1],
                 gt_masks_bev=masks)
    opt = bevfusion_optimizer(cfg, bundle, 100)
    step = make_bevfusion_train_step(bundle, opt)
    with Capture(tg, "_launch_gemm") as k4, Capture(tg, "_launch_dw") as kdw, \
            Capture(tg, "gather_rows") as k5, Capture(tl, "linear_sum_assignment") as klsa:
        step(train)
        torch.cuda.synchronize()
    held_st = hold_launches("map-seg train step", k4.calls, kdw.calls, k5.calls, klsa.calls)
    del k4, kdw, k5, klsa
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    step(train)
    torch.cuda.synchronize()
    times = []
    for _ in range(CL_TRAIN_ITERS):
        t0 = time.perf_counter()
        logs = {k: float(v) for k, v in step(train).items()}
        times.append((time.perf_counter() - t0) * 1e3)
    launches_st = main_path_launches(counters, "map-seg train step", CL_TRAIN_ITERS + 1, dict(
        gather_gemm=K4_PER_BF_TRAIN_STEP, gather_dw=K4_DW_PER_BF_TRAIN_STEP,
        gather_rows=K5_PER_BF_TRAIN_STEP, linear_sum_assignment=LSA_PER_BF_TRAIN_STEP))
    peak_st = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(v) for v in logs.values()) or not logs["seg_loss"] > 0:
        fail(f"map-seg train step logs {logs}")
    st_ms = float(np.median(times))
    split = bevfusion_train_split(bundle, opt, inputs, gt, 3, seg=seg_t)
    seg_share = split["seg loss"] / sum(split.values())
    print(f"map-seg train step (B={B}, f32): median {st_ms:.2f} ms over {CL_TRAIN_ITERS}; peak "
          f"memory {peak_st:.2f} GB; launches per step: K4 "
          f"{launches_st['gather_gemm'] // (CL_TRAIN_ITERS + 1)}, K4-dW "
          f"{launches_st['gather_dw'] // (CL_TRAIN_ITERS + 1)}, K5 "
          f"{launches_st['gather_rows'] // (CL_TRAIN_ITERS + 1)}, LSA "
          f"{launches_st['linear_sum_assignment'] // (CL_TRAIN_ITERS + 1)}; seg_loss "
          f"{logs['seg_loss']:.4f} of loss {logs['loss']:.4f}; split (ms, median of 3): "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
          + f"; the seg loss's share {seg_share:.3f}")
    device_profile(lambda: step(train), "map-seg train step", st_ms)
    del step, opt, predict, bundle, model, inputs, seg_t, out, seg
    torch.cuda.empty_cache()

    # -- CenterPoint: configs/bevfusion_lidar.py with head="centerpoint"
    cfg_c = Config.fromfile(os.path.join(ROOT, "configs", "bevfusion_lidar.py"))
    cfg_c["model"] = dict(cfg_c["model"], head="centerpoint")
    bundle = build_bevfusion(cfg_c, seed=0)
    model, tcfg = bundle.model, bundle.test_cfg
    inputs = bevfusion_inputs(model, {k: batch[k] for k in ("voxel_features", "voxel_coords",
                                                            "voxel_valid")}, dev)
    print(f"CenterPoint: lidar-only model + CenterHead (task groups {model.head.num_classes}, "
          f"shared conv {model.head.shared.conv.out_channels}; "
          f"{sum(p.numel() for p in model.head.parameters())} parameters) on the 180 x 180 neck "
          f"map; decode {tcfg}")

    def forward(k4):
        saved = tg.gather_gemm
        tg.gather_gemm = k4
        try:
            with torch.inference_mode(), autotuned_convs():
                preds = model(inputs["vf"].float(), inputs["vc"], inputs["vv"])["center_preds"]
                dec = center_head_decode(preds, tcfg)
            torch.cuda.synchronize()
        finally:
            tg.gather_gemm = saved
        return preds, dec

    gt_c = center_gt(18, dev)
    for c in counters:
        c.launches = 0
    forward(tg.gather_gemm)
    times, dec_ms = [], []
    for _ in range(CENTER_ITERS):
        t0 = time.perf_counter()
        pk, dk = forward(tg.gather_gemm)
        times.append((time.perf_counter() - t0) * 1e3)
    with torch.inference_mode():
        dec_ms = cuda_time_ms(lambda: center_head_decode(pk, tcfg), 5)
    loss_k, g_k = center_gradients(bundle, inputs, gt_c, False, tg)
    t0 = time.perf_counter()
    center_gradients(bundle, inputs, gt_c, False, tg)
    lb_ms = (time.perf_counter() - t0) * 1e3
    launches_c = main_path_launches(counters, "CenterPoint", 1, dict(
        gather_gemm=K4_PER_PREDICT * (CENTER_ITERS + 1) + 2 * K4_PER_PREDICT + 2 * 20,
        gather_dw=2 * K4_PER_PREDICT))
    pp, dp = forward(plain[0])
    heat = max(float((a["heatmap"] - b["heatmap"]).abs().max()) / max(
        float(b["heatmap"].abs().max()), 1e-30) for a, b in zip(pk, pp))
    other = max(float((a[k] - b[k]).abs().max()) / max(float(b[k].abs().max()), 1e-30)
                for a, b in zip(pk, pp) for k in a)
    if heat > CENTER_TOL or other > BF_TOL:
        fail(f"CenterPoint vs plain versions: heatmaps {heat:.2e} of scale (tol {CENTER_TOL:g}), "
             f"every map {other:.2e} (tol {BF_TOL:g})")
    # the decoded detections as sets: the same (pixel, class) picks per task,
    # paired, their boxes and scores; a pick on one side only sits at the
    # top-k boundary (its score within 1e-5 of the other side's last)
    flips, box_err, sc_err, o = 0, 0.0, 0.0, 0
    for t, (ik, ip) in enumerate(zip(center_topk(pk, tcfg), center_topk(pp, tcfg))):
        K = ik.shape[1]  # the task's picks: max_per_task, fewer on a map with fewer cells
        for b in range(B):
            pos = {int(v): j for j, v in enumerate(ip[b])}
            for i, v in enumerate(ik[b].tolist()):
                j = pos.get(v)
                if j is None:
                    flips += 1
                    if abs(float(dk["scores"][b, o + i] - dp["scores"][b, o + K - 1])) > 1e-5:
                        fail(f"CenterPoint decode vs plain: task {t} sample {b} pick {v} only on "
                             "the kernel side, away from the top-k boundary")
                    continue
                ba, bp = dk["box3d_lidar"][b, o + i].double(), dp["box3d_lidar"][b, o + j].double()
                box_err = max(box_err, float(((ba - bp).abs() / bp.abs().clamp(min=1.0)).max()))
                sc_err = max(sc_err, abs(float(dk["scores"][b, o + i] - dp["scores"][b, o + j])))
                if int(dk["label_preds"][b, o + i]) != int(dp["label_preds"][b, o + j]):
                    fail(f"CenterPoint decode vs plain: task {t} pick {v} has another label")
        o += K
    if box_err > BF_TOL or sc_err > 1e-5:
        fail(f"CenterPoint decode vs plain: box err {box_err:.2e}, score err {sc_err:.2e}")
    loss_p, g_p = center_gradients(bundle, inputs, gt_c, True, tg)
    noise = 1.0 + 1e-7 * torch.randn(inputs["vf"].shape,
                                      generator=torch.Generator().manual_seed(20)).to(dev)
    _, g_n = center_gradients(bundle, dict(inputs, vf=inputs["vf"] * noise), gt_c, True, tg)
    gap, floor = _grad_gap(g_p, g_k), _grad_gap(g_p, g_n)
    tol = max(STEP_TOL, 2 * floor)
    loss_gap = abs(loss_k - loss_p) / max(abs(loss_p), 1e-30)
    if not (gap <= tol and floor <= STEP_FLOOR_MAX and loss_gap <= CENTER_TOL
            and np.isfinite(loss_k)):
        fail(f"CenterPoint loss vs plain versions: loss {loss_k} / {loss_p} ({loss_gap:.2e}), "
             f"gradient gap {gap:.2e} (tol {tol:.2e}, floor {floor:.2e})")
    with Capture(tg, "_launch_gemm") as k4, Capture(tg, "_launch_dw") as kdw:
        center_gradients(bundle, inputs, gt_c, False, tg)
    held_c = hold_launches("CenterPoint forward + loss backward", k4.calls, kdw.calls)
    del k4, kdw
    n_valid = [int(x) for x in dk["det_valid"].sum(1)]
    print(f"CenterPoint (B={B}): forward + decode median {np.median(times):.2f} ms over "
          f"{CENTER_ITERS} (decode alone {dec_ms:.3f} ms of device time); train-mode forward + "
          f"center_head_loss + backward {lb_ms:.1f} ms; {n_valid} detections of "
          f"{dk['scores'].shape[1]} at score >= {tcfg.score_threshold}; vs plain versions: "
          f"heatmaps {heat:.1e} of scale, every map {other:.1e}, picks equal but {flips} at the "
          f"top-k boundary, boxes {box_err:.1e}, scores {sc_err:.1e}; loss {loss_k:.4f} within "
          f"{loss_gap:.1e}, gradient within {gap:.2e} of its norm (tol {tol:.2e}, rounding "
          f"alone {floor:.2e}); launches {launches_c}")
    del bundle, model, inputs, g_k, g_p, g_n, pk, pp
    torch.cuda.empty_cache()

    cli = map_seg_cli(tmp)
    print(f"phase 20 (BEVFusion map segmentation and CenterPoint): "
          f"{time.perf_counter() - t_phase:.1f} s")
    return dict(launches_seg_predict=launches_sp, launches_seg_train=launches_st,
                launches_centerpoint=launches_c, seg_predict_ms=sp_ms, seg_step_ms=st_ms,
                seg_split_ms=split, seg_share=seg_share, held=(held_st, held_c), cli=cli)


# ---------------------------------------------------------------------------
# phase 21: the CBGS backbone on the gather engine (A9.d.1)
# ---------------------------------------------------------------------------
GATHER_CAPS = (60000, 60000, 30000, 30000)
CBGS_GATHER_ITERS = 5
CBGS_GATHER_TRAIN_ITERS = 3


def cbgs_gather_gradients(bundle, inputs, gt, plain: bool, tg) -> tuple:
    """One CBGS train step's forward, target assignment, loss and backward
    without the update, with K4 or on its plain version; the running
    statistics are put back. Returns (loss, {name: grad})."""
    from dal3d_tpu_torch.models.heads.mg_head import multi_group_loss
    from dal3d_tpu_torch.runtime.steps import autotuned_convs

    model = bundle.model
    model.train()
    stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    model.zero_grad(set_to_none=True)
    saved = tg.gather_gemm
    if plain:
        tg.gather_gemm = lambda f, idx, hit, w, plan=None: tg.gather_gemm_plain(f, idx, hit, w)
    try:
        with autotuned_convs():
            out = model(**inputs)
            labels, targets, _ = bundle.assigner.assign_all(*gt)
            loss = multi_group_loss(out["preds"], labels, targets, bundle.num_classes,
                                    bundle.loss_cfg)["loss"]
            loss.backward()
        torch.cuda.synchronize()
    finally:
        tg.gather_gemm = saved
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k in stats:
                v.copy_(stats[k])
    return float(loss.detach()), grads


def cbgs_gather_clis(tmp: str) -> dict:
    """configs/cbgs_synthetic.py, cbgs_entropy_synthetic.py and
    cbgs_partial_synthetic.py as written (the gather engine) in a directory
    holding an 8-frame synthetic set at their relative paths: train (its
    workflow: two epochs, then val), active_select (entropy) twice, then one
    ActiveTrainer epoch. Returns seconds per CLI."""
    import json

    from dal3d_tpu_torch.runtime.checkpoint import latest_epoch
    from dal3d_tpu_torch.tools import active_select, create_data, train
    from dal3d_tpu_torch.utils.fileio import load

    base = os.path.join(tmp, "cbgs_gather_cli")
    os.makedirs(base)
    cfgs = {n: os.path.join(ROOT, "configs", f"cbgs_{n}synthetic.py")
            for n in ("", "entropy_", "partial_")}
    cwd = os.getcwd()
    os.chdir(base)
    seconds = {}

    def run(tag, fn, argv):
        t0 = time.perf_counter()
        r = fn(argv)
        torch.cuda.synchronize()
        seconds[tag] = time.perf_counter() - t0
        return r

    try:
        create_data.main(["synthetic_data_prep", "--root_path", "data/synthetic", "--n_frames",
                          "8", "--n_logs", "2", "--range_xy", "7"])
        tr = run("train cbgs_synthetic", train.main, [cfgs[""], "--seed", "0"])
        log = open("work_dirs/cbgs_synthetic/train.log").read()
        run("active_select (empty buffer)", active_select.main, [cfgs["entropy_"]])
        run("active_select --checkpoint", active_select.main,
            [cfgs["entropy_"], "--checkpoint", "work_dirs/cbgs_synthetic"])
        infos = load("data/synthetic/infos_train_10sweeps_withvelo.pkl")
        picked = load("data/buffers/synthetic_entropy.json")["3"]
        subset = load("data/synthetic/infos_train_10sweeps_withvelo_3.pkl")
        pt = run("train cbgs_partial_synthetic", train.main,
                 [cfgs["partial_"], "--seed", "0", "--epochs", "1", "--no_validate"])
        seed = json.load(open("data/buffers/partial_synth.json"))["partial_01"]
        est = dict(np.load("work_dirs/cbgs_partial_synth/estimator.npz"))
        plog = open("work_dirs/cbgs_partial_synth/train.log").read()
        epochs = (latest_epoch("work_dirs/cbgs_synthetic"),
                  latest_epoch("work_dirs/cbgs_partial_synth"))
    finally:
        os.chdir(cwd)
    impls = (tr.bundle.model.backbone.impl, pt.bundle.model.backbone.impl)
    if (impls != ("gather", "gather") or epochs != (2, 1) or "val epoch 2" not in log
            or "brick capacities" in log + plog
            or not picked or [i["token"] for i in subset] != [infos[k]["token"] for k in picked]
            or len(seed) != 4 or not est or not all(np.isfinite(v).all() for v in est.values())
            or pt.estimator_optimizer.count != pt.step or "ActiveTrainer" not in plog):
        fail(f"the synthetic CBGS configs through the CLIs: engines {impls}, epochs {epochs}, "
             f"picked {picked}, seed buffer {seed}, estimator arrays {len(est)}")
    print(f"  the synthetic CBGS configs as written (gather engine, caps "
          f"{tr.bundle.model.backbone.caps}) on 8 synthetic frames: "
          + "; ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
          + f"; entropy picks {picked}; seed buffer partial_01 {seed}; the trainers logged "
          "no capacity report (the gather engine has none, as in JAX)")
    return seconds


def cbgs_gather_phase(tmp: str, Config, counters, tg, tiou) -> dict:
    """Phase 21: the production CBGS model on the gather engine at full
    width (configs/cbgs_spatial_temporal.py with impl="gather", f32, voxel
    caps GATHER_CAPS), B=2: predict and a train step, then the synthetic
    CBGS configs through the CLIs. Returns each kernel's launches over the
    predict and the train step main paths, and the numbers."""
    from dal3d_tpu_torch.models.builder import build_detector
    from dal3d_tpu_torch.models.heads.mg_head import multi_group_predict
    from dal3d_tpu_torch.ops.nms import greedy_nms_from_iou
    from dal3d_tpu_torch.runtime.capacity import brick_capacity_report
    from dal3d_tpu_torch.runtime.steps import (autotuned_convs, make_predict_step,
                                               make_train_step, model_inputs)
    from dal3d_tpu_torch.solver.optim import OneCycleSchedule, build_optimizer

    t_phase = time.perf_counter()
    cfg = Config.fromfile(os.path.join(ROOT, "configs", "cbgs_spatial_temporal.py"))
    bb = {k: v for k, v in dict(cfg["model"]["backbone"]).items()
          if k not in ("brick_widths", "banded_caps", "band_widths", "down_bands")}
    cfg["model"] = dict(cfg["model"], backbone=dict(bb, impl="gather", dtype="float32",
                                                    voxel_caps=GATHER_CAPS))
    vf, vc, vv, n_vox = make_batch(0, cfg)
    batch = {"voxel_features": torch.from_numpy(vf), "voxel_coords": torch.from_numpy(vc),
             "voxel_valid": torch.from_numpy(vv)}
    bundle = build_detector(cfg, seed=0)
    model, dev = bundle.model, bundle.device
    predict = make_predict_step(bundle)
    rows = brick_capacity_report(bundle, batch)
    if rows:
        fail(f"the capacity report gave rows {rows} for the gather engine")
    print(f"CBGS on the gather engine: phase 3's voxels {n_vox} (f32), backbone caps "
          f"{model.backbone.caps}, {sum(p.numel() for p in model.parameters())} parameters; the "
          "capacity report has no rows for it, as JAX's")
    with Capture(tg, "_launch_gemm") as k4, Capture(tiou, "iou_matrix") as k2:
        predict(batch)
        torch.cuda.synchronize()
    if (len(k4.calls), len(k2.calls)) != (K4_PER_PREDICT, K2_PER_PREDICT):
        fail(f"CBGS gather predict launched K4 {len(k4.calls)}x, K2 {len(k2.calls)}x")
    held_p = hold_launches("CBGS gather predict", k4.calls, k2=k2.calls)
    del k4, k2
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = predict(batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(CBGS_GATHER_ITERS):
        t0 = time.perf_counter()
        out = predict(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches_p = main_path_launches(counters, "CBGS gather predict", CBGS_GATHER_ITERS + 1,
                                    dict(gather_gemm=K4_PER_PREDICT, iou_matrix=K2_PER_PREDICT))
    peak_p = torch.cuda.max_memory_allocated() / 1e9
    for k, shp in {"box3d_lidar": (B, 498, 9), "scores": (B, 498), "embedding": (B, 512)}.items():
        if tuple(out[k].shape) != shp or not bool(torch.isfinite(out[k]).all()):
            fail(f"CBGS gather predict output {k}: {tuple(out[k].shape)}")
    n_det = [int(x) for x in out["det_valid"].sum(1)]
    if min(n_det) == 0:
        fail(f"CBGS gather predict: no detections {n_det}")
    p_ms = float(np.median(times))
    # the same predict on plain versions: maps, then the detections matched
    saved = tg.gather_gemm, tiou.iou_matrix
    tg.gather_gemm = lambda f, idx, hit, w, plan=None: tg.gather_gemm_plain(f, idx, hit, w)
    tiou.iou_matrix = tiou.iou_matrix_plain
    try:
        with torch.inference_mode(), autotuned_convs():
            mp = model(**model_inputs(batch, dev))
        ref = predict(batch)
        torch.cuda.synchronize()
    finally:
        tg.gather_gemm, tiou.iou_matrix = saved
    with torch.inference_mode(), autotuned_convs():
        mk = model(**model_inputs(batch, dev))
    pairs = [("dense", mk["dense"], mp["dense"]), ("embedding", mk["embedding"], mp["embedding"])]
    pairs += [(f"{n}[{t}]", a[n], b_[n]) for t, (a, b_) in enumerate(zip(mk["preds"], mp["preds"]))
              for n in ("box_preds", "cls_preds")]
    map_err = max(float((a - b_).abs().max()) / max(float(b_.abs().max()), 1e-30)
                  for _, a, b_ in pairs)
    matched = [match_dets(out, ref, i) for i in range(B)]
    unmatched = sum(m[2] for m in matched)
    box_err = max(m[0] for m in matched)
    if map_err > BF_TOL or unmatched > max(2, sum(n_det) // 100) or box_err > BF_TOL:
        fail(f"CBGS gather predict vs plain versions: maps {map_err:.2e} of scale, "
             f"{unmatched} unmatched detections of {sum(n_det)}, box err {box_err:.2e}")
    # phase 23 holds the bf16 engines to these f32 maps and detections
    f32_ref = dict(maps=maps_cpu(mk), out={k: v.cpu() for k, v in out.items()},
                   sd={k: v.cpu().clone() for k, v in model.state_dict().items()}, batch=batch)
    del mk, mp
    print(f"CBGS gather predict (B={B}): median {p_ms:.2f} ms, mean {np.mean(times):.2f} ms over "
          f"{CBGS_GATHER_ITERS} -> {B / p_ms * 1e3:.2f} scans/s; peak memory {peak_p:.2f} GB; "
          f"detections {n_det}; launches K4 {launches_p['gather_gemm']} K2 "
          f"{launches_p['iou_matrix']} in {CBGS_GATHER_ITERS + 1} predicts, no other kernel; vs "
          f"plain versions: dense, embedding and 12 head maps within {map_err:.1e} of scale, "
          f"detections matched but {unmatched} of {sum(n_det)} (box err {box_err:.1e})")
    stage_split(bundle, batch, multi_group_predict, greedy_nms_from_iou, tiou)
    fft = sorted(n for n in device_profile(lambda: predict(batch), "CBGS gather predict", p_ms)
                 if "fft" in n.lower())
    if fft:
        fail(f"CBGS gather predict ran cuDNN's FFT route ({fft[:2]}): a call outside the "
             "autotuner chose these shapes' plans first, and PyTorch's plan cache served them")
    print("  no cuDNN FFT kernel in the predict's profile (the autotuner chose its convs)")

    # one train step
    gtb, gtc = random_gt(cfg, np.random.RandomState(21), B, 8, 45.0)
    train = dict(batch, gt_boxes=gtb, gt_classes=gtc)
    inputs = model_inputs(batch, dev)
    gt = ([torch.from_numpy(x).to(dev) for x in gtb], [torch.from_numpy(x).to(dev) for x in gtc])
    loss_k, g_k = cbgs_gather_gradients(bundle, inputs, gt, False, tg)
    loss_p, g_p = cbgs_gather_gradients(bundle, inputs, gt, True, tg)
    noise = 1.0 + 1e-7 * torch.randn(inputs["vf"].shape,
                                      generator=torch.Generator().manual_seed(21)).to(dev)
    _, g_n = cbgs_gather_gradients(bundle, dict(inputs, vf=inputs["vf"] * noise), gt, True, tg)
    gap, floor = _grad_gap(g_p, g_k), _grad_gap(g_p, g_n)
    stem = "backbone.l0.stem.weight"
    stem_gap = _grad_gap({stem: g_p[stem]}, {stem: g_k[stem]})
    stem_floor = _grad_gap({stem: g_p[stem]}, {stem: g_n[stem]})
    tol, stem_tol = max(STEP_TOL, 2 * floor), max(STEP_TOL, 2 * stem_floor)
    loss_gap = abs(loss_k - loss_p) / max(abs(loss_p), 1e-30)
    if not (gap <= tol and stem_gap <= stem_tol and max(floor, stem_floor) <= STEP_FLOOR_MAX
            and loss_gap <= 1e-4 and float(g_k[stem].abs().max()) > 0):
        fail(f"CBGS gather train step vs plain versions: gradient gap {gap:.2e} (tol {tol:.2e}; "
             f"floor {floor:.2e}), the stem's {stem_gap:.2e} (tol {stem_tol:.2e}), loss gap "
             f"{loss_gap:.2e}")
    del g_k, g_p, g_n
    opt = build_optimizer(OneCycleSchedule(total_steps=100)).init(model.named_parameters())
    step = make_train_step(bundle, opt)
    with Capture(tg, "_launch_gemm") as k4, Capture(tg, "_launch_dw") as kdw:
        step(train)
        torch.cuda.synchronize()
    held_t = hold_launches("CBGS gather train step", k4.calls, kdw.calls)
    n_dx = len(k4.calls) - K4_PER_PREDICT
    if (n_dx, len(kdw.calls)) != (20, K4_PER_PREDICT):  # the stem's voxel features need no dX
        fail(f"CBGS gather train step launched {n_dx} K4 input gradients and "
             f"{len(kdw.calls)} K4-dW; expected 20 and {K4_PER_PREDICT}")
    del k4, kdw
    for c in counters:
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    step(train)
    torch.cuda.synchronize()
    times = []
    for _ in range(CBGS_GATHER_TRAIN_ITERS):
        t0 = time.perf_counter()
        logs = {k: float(v) for k, v in step(train).items()}
        times.append((time.perf_counter() - t0) * 1e3)
    launches_t = main_path_launches(counters, "CBGS gather train step",
                                    CBGS_GATHER_TRAIN_ITERS + 1,
                                    dict(gather_gemm=K4_PER_PREDICT + n_dx,
                                         gather_dw=K4_PER_PREDICT))
    peak_t = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(v) for v in logs.values()):
        fail(f"CBGS gather train step logs {logs}")
    t_ms = float(np.median(times))
    split = train_step_split(bundle, opt, train)
    print(f"CBGS gather train step (B={B}, f32): median {t_ms:.2f} ms over "
          f"{CBGS_GATHER_TRAIN_ITERS}; peak memory {peak_t:.2f} GB; launches per step: K4 "
          f"{K4_PER_PREDICT} + {n_dx} input gradients, K4-dW {K4_PER_PREDICT}, no other "
          f"kernel; vs plain versions: gradient within {gap:.2e} of its norm (tol {tol:.2e}, "
          f"rounding alone {floor:.2e}), the stem's {stem_gap:.2e} (tol {stem_tol:.2e}), loss "
          f"{loss_gap:.1e}; logs {logs}; split (ms, median of 3): "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    device_profile(lambda: step(train), "CBGS gather train step", t_ms)
    del step, opt, predict, bundle, model, inputs
    torch.cuda.empty_cache()

    cli_s = cbgs_gather_clis(tmp)
    print(f"phase 21 (the CBGS backbone on the gather engine): "
          f"{time.perf_counter() - t_phase:.1f} s")
    return dict(launches_predict=launches_p, launches_train=launches_t, predict_ms=p_ms,
                step_ms=t_ms, split_ms=split, held=(held_p, held_t), cli_s=cli_s,
                step_gap=dict(gap=gap, floor=floor, stem_gap=stem_gap, stem_floor=stem_floor),
                f32_ref=f32_ref)


# ---------------------------------------------------------------------------
# phase 22: the other backbone engines (A9.d.2-4)
# ---------------------------------------------------------------------------
ENGINE_ITERS = 3
ENGINE_TRAIN_ITERS = 2
DENSE_ITERS = 2
K4_PER_HYBRID = 6  # the gather L0: stem, 4 subm convs, the downsample
BRICK_TOL = 2e-2  # of scale: the brick engine's maps against the banded engine's (bf16)
ORACLE_TOL = 1e-4  # of scale: the gather engine's maps against the dense engine's (f32)
SORTED_TOL = 1e-6  # of scale: the gather convs on the sorted plans against the grid plans
BF16_NUDGE = 2.0 ** -8  # one bf16 ulp: the rounding floor's perturbation of bf16 features
# a box's error relative to max(1, |box|), hybrid against plain versions: K4's rounding
# (2e-7 of scale) passes through 15 f32 dense layers (maps ~4e-6 of scale) and the
# decode's exp of the log sizes
HYBRID_BOX_TOL = 1e-3


def engine_cfg(Config, impl: str, **bb):
    """configs/cbgs_spatial_temporal.py with backbone ``impl`` and knobs
    ``bb`` (the banded engine's own knobs dropped)."""
    cfg = Config.fromfile(os.path.join(ROOT, "configs", "cbgs_spatial_temporal.py"))
    keep = {k: v for k, v in dict(cfg["model"]["backbone"]).items()
            if k not in ("banded_caps", "band_widths", "down_bands", "band_fb_cap")}
    cfg["model"] = dict(cfg["model"], backbone=dict(keep, impl=impl, **bb))
    return cfg


def engine_bundle(cfg, sd):
    """build_detector on the card with the shared state dict ``sd``."""
    from dal3d_tpu_torch.models.builder import build_detector

    bundle = build_detector(cfg, seed=0)
    bundle.model.load_state_dict(sd, strict=True)
    return bundle


def engine_gradients(bundle, inputs, gt, plain: bool, tg, bd) -> tuple:
    """One CBGS train step's forward, target assignment, loss and backward
    without the update, on the kernels or with every kernel wrapper (K1, K3,
    K4) swapped for its plain version; the running statistics are put
    back. Returns (loss, {name: grad})."""
    saved = tg.gather_gemm, bd.banded_conv, bd.banded_dw
    if plain:
        tg.gather_gemm = lambda f, idx, hit, w, plan=None: tg.gather_gemm_plain(f, idx, hit, w)
        bd.banded_conv, bd.banded_dw = bd.banded_conv_plain, bd.banded_dw_plain
    try:
        return cbgs_gather_gradients(bundle, inputs, gt, False, tg)
    finally:
        tg.gather_gemm, bd.banded_conv, bd.banded_dw = saved


def gradient_floor(bundle, inputs, gt, tg, bd, tag: str) -> dict:
    """The train step's gradient on the kernels against the plain versions',
    held within twice the gap rounding alone opens (the plain step on
    features moved by about one ulp of their type), and at least STEP_TOL;
    the loss within 1e-4 (f32) or 1e-2 (bf16)."""
    bf16 = bundle.model.backbone.l0.stem.dtype == torch.bfloat16
    loss_k, g_k = engine_gradients(bundle, inputs, gt, False, tg, bd)
    loss_p, g_p = engine_gradients(bundle, inputs, gt, True, tg, bd)
    nudge = BF16_NUDGE if bf16 else 1e-7
    vf = inputs["vf"]
    noise = 1.0 + nudge * torch.randn(vf.shape, generator=torch.Generator().manual_seed(22))
    moved = (vf.float() * noise.to(vf.device)).to(vf.dtype)
    _, g_n = engine_gradients(bundle, dict(inputs, vf=moved), gt, True, tg, bd)
    gap, floor = _grad_gap(g_p, g_k), _grad_gap(g_p, g_n)
    tol = max(STEP_TOL, 2 * floor)
    loss_gap = abs(loss_k - loss_p) / max(abs(loss_p), 1e-30)
    stem = "backbone.l0.stem.weight"
    if not (gap <= tol and loss_gap <= (1e-2 if bf16 else 1e-4)
            and float(g_k[stem].abs().max()) > 0):
        fail(f"{tag} train step vs plain versions: gradient gap {gap:.2e} (tol {tol:.2e}; "
             f"floor {floor:.2e}), loss gap {loss_gap:.2e}")
    return dict(gap=gap, floor=floor, tol=tol, loss_gap=loss_gap)


def hold_banded(tag: str, k1=(), k3=()) -> dict:
    """Every captured K1 / K3 launch against its plain version on the same
    inputs: K1 within one bf16 ulp of the output's scale (2^-7), K3 within
    1e-3 of its scale, as phases 3 and 9 hold them. Returns {kernel:
    (launches, max error relative to scale)}."""
    from dal3d_tpu_torch.ops import banded as bd

    def rel(got, ref):
        return float((got.float() - ref.float()).abs().max()) / max(
            float(ref.float().abs().max()), 1e-30)

    with torch.no_grad():
        e1 = [rel(bd.banded_conv(tb, idx, w), bd.banded_conv_plain(tb, idx, w))
              for tb, idx, w in k1]
        e3 = [rel(bd.banded_dw(tb, idx, g), bd.banded_dw_plain(tb, idx, g)) for tb, idx, g in k3]
    if max(e1, default=0.0) > 2.0 ** -7 or max(e3, default=0.0) > 1e-3:
        fail(f"{tag}: a K1 launch {max(e1, default=0):.2e} or a K3 launch "
             f"{max(e3, default=0):.2e} of scale from its plain version")
    out = {"banded_conv": (len(e1), max(e1, default=0.0)),
           "banded_dw": (len(e3), max(e3, default=0.0))}
    print(f"{tag}: every launch against its plain version: "
          + ", ".join(f"{k} {n} within {e:.1e}" for k, (n, e) in out.items() if n))
    return out


def brick_level_cells(backbone) -> tuple:
    """Each downsample output's brick cells (D * H * W / bw) of a brick
    backbone: one more is a cap no active set can fill."""
    D, H, W = backbone.sparse_shape
    out = []
    for lvl, bw in zip((backbone.l0, backbone.stage1, backbone.stage2, backbone.stage3),
                       backbone.widths[1:]):
        d = lvl.down
        k, st, p = (tuple(v) if isinstance(v, (tuple, list)) else (v,) * 3
                    for v in (d.kernel_size, d.stride, d.padding))
        D, H, W = ((n + 2 * p_ - k_) // s_ + 1 for n, k_, s_, p_ in zip((D, H, W), k, st, p))
        out.append(D * H * (W // bw))
    return tuple(out)


def loose_matches(out, ref) -> tuple:
    """Phase 5's detection match of a bf16 path against its plain versions:
    (matched, total), a detection matched where one of the other run has
    its label, a centre within 0.1 m and a score within 0.02."""
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
    return found, total


def stamp(t0: float, what: str) -> None:
    """Seconds since ``t0`` at the end of a part of a phase."""
    print(f"  [{time.perf_counter() - t0:.1f} s] {what}", flush=True)


def timed_runs(counters, fn, iters: int, tag: str) -> tuple:
    """Counters set to 0, then a warm-up and ``iters`` timed calls of ``fn``
    (host clock, synchronized); the warm-up's ms are printed apart (cuDNN's
    autotuner times every new conv shape in it). Returns (median ms, last
    output, runs, peak GB of the warm-up, peak GB of the timed calls)."""
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    print(f"  {tag}: warm-up call {(time.perf_counter() - t0) * 1e3:.1f} ms")
    first_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return (float(np.median(times)), out, iters + 1, first_peak,
            torch.cuda.max_memory_allocated() / 1e9)


def as_grid(m) -> tuple:
    """A middle level of any engine -> (dense [B, D, H, W, C] f32, bool
    occupancy [B, D, H, W]) on its device."""
    from dal3d_tpu_torch.ops import dense_sparse as ds
    from dal3d_tpu_torch.ops import sparse_backend as sp

    if isinstance(m, tuple):
        return m[0].float(), m[1] > 0
    if isinstance(m, sp.SparseBatch):
        d, o = ds.to_dense_grid(m.replace(features=m.features.float()))
        return d, o > 0
    B, Mb, _ = m.features.shape
    D, H, W = m.shape
    nbc, dev = m.num_cells, m.features.device
    dense = torch.zeros(B, nbc + 1, m.bw, m.channels, device=dev)
    occ = torch.zeros(B, nbc + 1, m.bw, dtype=torch.bool, device=dev)
    lin = torch.clamp(m.brick_lin.long(), max=nbc)
    dense.scatter_(1, lin[..., None, None].expand(B, Mb, m.bw, m.channels), m.feat4().float())
    occ.scatter_(1, lin[..., None].expand(B, Mb, m.bw), m.vmask)
    return (dense[:, :nbc].reshape(B, D, H, W, m.channels), occ[:, :nbc].reshape(B, D, H, W))


def levels_gap(a_mid, b_mid) -> list:
    """Per level: (occupancies equal, max |a - b| relative to b's scale)."""
    out = []
    for a, b in zip(a_mid, b_mid):
        (da, oa), (db, ob) = as_grid(a), as_grid(b)
        out.append((bool(torch.equal(oa, ob)),
                    float((da - db).abs().max()) / max(float(db.abs().max()), 1e-30)))
        del da, oa, db, ob
    return out


def forward_maps(bundle, batch):
    from dal3d_tpu_torch.runtime.steps import autotuned_convs, model_inputs

    with torch.inference_mode(), autotuned_convs():
        return bundle.model(**model_inputs(batch, bundle.device))


def maps_cpu(m) -> dict:
    """The dense, embedding and head maps of a forward, on the CPU."""
    return dict(dense=m["dense"].cpu(), embedding=m["embedding"].cpu(),
                preds=[{n: p[n].cpu() for n in ("box_preds", "cls_preds")} for p in m["preds"]])


def maps_gap(mk, mp) -> float:
    """dense, embedding and the 12 head maps: max error relative to scale."""
    pairs = [(mk["dense"], mp["dense"]), (mk["embedding"], mp["embedding"])]
    pairs += [(a[n], b_[n]) for a, b_ in zip(mk["preds"], mp["preds"])
              for n in ("box_preds", "cls_preds")]
    return max(float((a.float() - b_.float()).abs().max()) / max(float(b_.float().abs().max()),
                                                                 1e-30) for a, b_ in pairs)


def plain_predict(bundle, predict, batch, tg, bd, tiou) -> tuple:
    """The forward's maps and the predict's detections with every kernel
    wrapper (K1, K4, K2) swapped for its plain version."""
    saved = tg.gather_gemm, bd.banded_conv, tiou.iou_matrix
    tg.gather_gemm = lambda f, idx, hit, w, plan=None: tg.gather_gemm_plain(f, idx, hit, w)
    bd.banded_conv, tiou.iou_matrix = bd.banded_conv_plain, tiou.iou_matrix_plain
    try:
        mp = forward_maps(bundle, batch)
        ref = predict(batch)
        torch.cuda.synchronize()
    finally:
        tg.gather_gemm, bd.banded_conv, tiou.iou_matrix = saved
    return mp, ref


def engine_train(bundle, batch, gt_np, counters, per_step: dict, tag: str) -> dict:
    """Counters set to 0, a warm-up and ENGINE_TRAIN_ITERS timed train steps,
    launches held to ``per_step``; the split, peak memory and idle share."""
    from dal3d_tpu_torch.runtime.steps import make_train_step
    from dal3d_tpu_torch.solver.optim import OneCycleSchedule, build_optimizer

    train = dict(batch, gt_boxes=gt_np[0], gt_classes=gt_np[1])
    opt = build_optimizer(OneCycleSchedule(total_steps=100)).init(bundle.model.named_parameters())
    step = make_train_step(bundle, opt)
    t_ms, logs, runs, first_peak, peak = timed_runs(
        counters, lambda: {k: float(v) for k, v in step(train).items()}, ENGINE_TRAIN_ITERS, tag)
    launches = main_path_launches(counters, tag, runs, per_step)
    if not all(np.isfinite(v) for v in logs.values()):
        fail(f"{tag} logs {logs}")
    split = train_step_split(bundle, opt, train)
    print(f"{tag} (B={B}): median {t_ms:.2f} ms over {ENGINE_TRAIN_ITERS}; peak memory "
          f"{peak:.2f} GB (first step {first_peak:.2f}); launches per step "
          f"{ {k: v // runs for k, v in launches.items() if v} }; logs {logs}; split (ms, "
          "median of 3): " + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    prof = device_profile(lambda: step(train), tag, t_ms)
    del step, opt
    return dict(ms=t_ms, launches=launches, split=split, peak=peak, first_peak=first_peak,
                busy=sum(v[0] for v in prof.values()))


def brick_engine(Config, sd, batch, gt, gt_np, counters, tg, bd, tiou) -> dict:
    """The brick engine (the config's bf16, brick_caps): capacity report,
    every K1 launch of a predict, ENGINE_ITERS timed predicts, the maps and middle
    against the banded engine's, the detections against plain versions, a
    train step's gradient against plain versions, every K1 / K3 launch of a
    step, ENGINE_TRAIN_ITERS timed steps."""
    from dal3d_tpu_torch.models.heads.mg_head import multi_group_predict
    from dal3d_tpu_torch.ops.nms import greedy_nms_from_iou
    from dal3d_tpu_torch.runtime.capacity import brick_capacity_report
    from dal3d_tpu_torch.runtime.steps import make_predict_step, make_train_step, model_inputs
    from dal3d_tpu_torch.solver.optim import OneCycleSchedule, build_optimizer

    bundle = engine_bundle(engine_cfg(Config, "brick"), sd)
    rows = brick_capacity_report(bundle, batch)
    print("brick engine (bf16, caps " f"{bundle.model.backbone.caps}): active bricks per level "
          "(max over the batch) / cap: " + ", ".join(
              f"L{r['level']} {r['active']}/{r['cap']}" + (" SATURATED" if r["saturated"] else "")
              for r in rows))
    predict = make_predict_step(bundle)
    with Capture(bd, "banded_conv") as k1, Capture(tiou, "iou_matrix") as k2:
        predict(batch)
        torch.cuda.synchronize()
    if (len(k1.calls), len(k2.calls)) != (K1_PER_PREDICT, K2_PER_PREDICT):
        fail(f"brick predict launched K1 {len(k1.calls)}x, K2 {len(k2.calls)}x")
    held = hold_banded("brick predict", k1.calls)
    hold_launches("brick predict", k2=k2.calls)
    del k1, k2
    p_ms, out, runs, first_peak, peak = timed_runs(counters, lambda: predict(batch), ENGINE_ITERS,
                                                   "brick predict")
    launches_p = main_path_launches(counters, "brick predict", runs,
                                    dict(banded_conv=K1_PER_PREDICT, iou_matrix=K2_PER_PREDICT))
    n_det = [int(x) for x in out["det_valid"].sum(1)]
    if min(n_det) == 0 or not bool(torch.isfinite(out["box3d_lidar"]).all()):
        fail(f"brick predict: detections {n_det}")
    # against the banded engine on the same weights, both at caps no level
    # can fill (one more than each level's brick cells; L0's demand is below
    # the production cap), so that neither drops a brick
    nbc = brick_level_cells(bundle.model.backbone)
    wide = {k: (bundle.model.backbone.caps[0],) + tuple(n + 1 for n in nbc)
            for k in ("brick_caps", "banded_caps")}
    if rows[0]["saturated"]:
        fail(f"brick engine: L0's demand {rows[0]['active']} is over its cap")
    wb = engine_bundle(engine_cfg(Config, "brick", brick_caps=wide["brick_caps"]), sd)
    wr = engine_bundle(engine_cfg(Config, "banded", banded_caps=wide["banded_caps"]), sd)
    wide_rows = [brick_capacity_report(b, batch) for b in (wb, wr)]
    if any(r["saturated"] for rs in wide_rows for r in rs):
        fail(f"brick vs banded at wide caps: a level fills its cap {wide_rows}")
    mk, mb = forward_maps(wb, batch), forward_maps(wr, batch)
    lv = levels_gap(mk["middle"], mb["middle"])
    map_gap = maps_gap(mk, mb)
    if any(not a or g > BRICK_TOL for a, g in lv) or map_gap > BRICK_TOL:
        fail(f"brick vs banded: levels {lv}, maps {map_gap}")
    del mk, mb, wb, wr
    mk = forward_maps(bundle, batch)
    mp, ref = plain_predict(bundle, predict, batch, tg, bd, tiou)
    plain_gap = maps_gap(mk, mp)
    if plain_gap > 5e-2:
        fail(f"brick predict vs plain versions: maps {plain_gap:.2e} of scale")
    found, total = loose_matches(out, ref)
    del mk, mp
    print(f"brick predict (B={B}, bf16): median {p_ms:.2f} ms over {ENGINE_ITERS} -> "
          f"{B / p_ms * 1e3:.2f} scans/s; peak memory {peak:.2f} GB (first call {first_peak:.2f}); "
          f"detections {n_det}; launches K1 {launches_p['banded_conv']} K2 "
          f"{launches_p['iou_matrix']} in {runs}; vs the banded engine on the same weights, "
          f"both at caps {wide['brick_caps']} that no level fills (active bricks "
          f"{[r['active'] for r in wide_rows[0]]} and {[r['active'] for r in wide_rows[1]]}): "
          f"every level's active set equal, features within "
          f"{[f'{g:.1e}' for _, g in lv]} of scale, dense, embedding and 12 head maps within "
          f"{map_gap:.2e} (tol {BRICK_TOL}); vs plain versions: maps within {plain_gap:.1e} of "
          f"scale (tol 5e-2, phase 5's), detections matched {found}/{total} (phase 5's loose "
          "match: bf16 reorders the near-equal scores of random weights)")
    stage_split(bundle, batch, multi_group_predict, greedy_nms_from_iou, tiou)
    device_profile(lambda: predict(batch), "brick predict", p_ms)
    inputs = model_inputs(batch, bundle.device)
    grad = gradient_floor(bundle, inputs, gt, tg, bd, "brick")
    opt = build_optimizer(OneCycleSchedule(total_steps=100)).init(bundle.model.named_parameters())
    step = make_train_step(bundle, opt)
    with Capture(bd, "banded_conv") as k1, Capture(bd, "banded_dw") as k3:
        step(dict(batch, gt_boxes=gt_np[0], gt_classes=gt_np[1]))
        torch.cuda.synchronize()
    if (len(k1.calls), len(k3.calls)) != (K1_PER_TRAIN_STEP, K3_PER_TRAIN_STEP):
        fail(f"brick train step launched K1 {len(k1.calls)}x, K3 {len(k3.calls)}x")
    held_t = hold_banded("brick train step", k1.calls, k3.calls)
    del k1, k3, step, opt
    print(f"brick train step vs plain versions: gradient within {grad['gap']:.2e} of its norm "
          f"(tol {grad['tol']:.2e}, rounding alone {grad['floor']:.2e} with features moved by "
          f"one bf16 ulp), loss {grad['loss_gap']:.1e}")
    tr = engine_train(bundle, batch, gt_np, counters,
                      dict(banded_conv=K1_PER_TRAIN_STEP, banded_dw=K3_PER_TRAIN_STEP),
                      "brick train step")
    del bundle, predict
    torch.cuda.empty_cache()
    return dict(predict_ms=p_ms, launches_predict=launches_p, launches_train=tr["launches"],
                train=tr, grad=grad, held=(held, held_t), levels=lv, map_gap=map_gap,
                capacity=rows)


def hybrid_engine(Config, sd, batch, gt, gt_np, counters, tg, bd, tiou) -> dict:
    """The hybrid engine (f32, voxel caps (60000, 60000, 30000, 30000)):
    every K4 launch of a predict, ENGINE_ITERS timed predicts, maps and
    detections against plain versions, a train step's gradient against
    plain versions, every K4 / dX / K4-dW launch of a step,
    ENGINE_TRAIN_ITERS timed steps."""
    from dal3d_tpu_torch.models.heads.mg_head import multi_group_predict
    from dal3d_tpu_torch.ops.nms import greedy_nms_from_iou
    from dal3d_tpu_torch.runtime.steps import make_predict_step, make_train_step, model_inputs
    from dal3d_tpu_torch.solver.optim import OneCycleSchedule, build_optimizer

    bundle = engine_bundle(engine_cfg(Config, "hybrid", dtype="float32", voxel_caps=GATHER_CAPS),
                           sd)
    t0 = time.perf_counter()
    predict = make_predict_step(bundle)
    with Capture(tg, "_launch_gemm") as k4, Capture(tiou, "iou_matrix") as k2:
        predict(batch)
        torch.cuda.synchronize()
    if (len(k4.calls), len(k2.calls)) != (K4_PER_HYBRID, K2_PER_PREDICT):
        fail(f"hybrid predict launched K4 {len(k4.calls)}x, K2 {len(k2.calls)}x")
    held_p = hold_launches("hybrid predict", k4.calls, k2=k2.calls)
    del k4, k2
    stamp(t0, "hybrid: a predict's launches held")
    p_ms, out, runs, first_peak, peak = timed_runs(counters, lambda: predict(batch), ENGINE_ITERS,
                                                   "hybrid predict")
    launches_p = main_path_launches(counters, "hybrid predict", runs,
                                    dict(gather_gemm=K4_PER_HYBRID, iou_matrix=K2_PER_PREDICT))
    n_det = [int(x) for x in out["det_valid"].sum(1)]
    if min(n_det) == 0 or not bool(torch.isfinite(out["box3d_lidar"]).all()):
        fail(f"hybrid predict: detections {n_det}")
    mk = forward_maps(bundle, batch)
    mp, ref = plain_predict(bundle, predict, batch, tg, bd, tiou)
    map_gap = maps_gap(mk, mp)
    matched = [match_dets(out, ref, i) for i in range(B)]
    unmatched, box_err = sum(m[2] for m in matched), max(m[0] for m in matched)
    if map_gap > BF_TOL or unmatched > max(2, sum(n_det) // 100) or box_err > HYBRID_BOX_TOL:
        fail(f"hybrid predict vs plain versions: maps {map_gap:.2e} of scale, {unmatched} "
             f"unmatched of {sum(n_det)}, box err {box_err:.2e}")
    del mk, mp
    print(f"hybrid predict (B={B}, f32): median {p_ms:.2f} ms over {ENGINE_ITERS} -> "
          f"{B / p_ms * 1e3:.2f} scans/s; peak memory {peak:.2f} GB (first call, with the "
          f"autotuner's trials, {first_peak:.2f}); detections {n_det}; launches K4 "
          f"{launches_p['gather_gemm']} K2 {launches_p['iou_matrix']} in {runs}; vs plain "
          f"versions: dense, embedding and 12 head maps within {map_gap:.1e} of scale, detections "
          f"matched but {unmatched} of {sum(n_det)} (box err {box_err:.1e}, tol "
          f"{HYBRID_BOX_TOL})")
    stage_split(bundle, batch, multi_group_predict, greedy_nms_from_iou, tiou)
    device_profile(lambda: predict(batch), "hybrid predict", p_ms)
    stamp(t0, "hybrid: predicts timed, against plain versions, split, profile")
    inputs = model_inputs(batch, bundle.device)
    grad = gradient_floor(bundle, inputs, gt, tg, bd, "hybrid")
    stamp(t0, "hybrid: the step's gradient and its floor")
    opt = build_optimizer(OneCycleSchedule(total_steps=100)).init(bundle.model.named_parameters())
    step = make_train_step(bundle, opt)
    with Capture(tg, "_launch_gemm") as k4, Capture(tg, "_launch_dw") as kdw:
        step(dict(batch, gt_boxes=gt_np[0], gt_classes=gt_np[1]))
        torch.cuda.synchronize()
    n_dx = len(k4.calls) - K4_PER_HYBRID
    if (n_dx, len(kdw.calls)) != (K4_PER_HYBRID - 1, K4_PER_HYBRID):
        fail(f"hybrid train step launched {n_dx} K4 input gradients and {len(kdw.calls)} K4-dW")
    held_t = hold_launches("hybrid train step", k4.calls, kdw.calls)
    del k4, kdw, step, opt
    print(f"hybrid train step vs plain versions: gradient within {grad['gap']:.2e} of its norm "
          f"(tol {grad['tol']:.2e}, rounding alone {grad['floor']:.2e}), loss "
          f"{grad['loss_gap']:.1e}")
    tr = engine_train(bundle, batch, gt_np, counters,
                      dict(gather_gemm=K4_PER_HYBRID + n_dx, gather_dw=K4_PER_HYBRID),
                      "hybrid train step")
    stamp(t0, "hybrid: train steps timed, split, profile")
    del bundle, predict
    torch.cuda.empty_cache()
    return dict(predict_ms=p_ms, launches_predict=launches_p, launches_train=tr["launches"],
                train=tr, grad=grad, held=(held_p, held_t), map_gap=map_gap)


def dense_engine(Config, sd, batch, gt_np, counters, tiou) -> dict:
    """The dense engine (f32): DENSE_ITERS timed predicts with the peak memory, the
    on-card oracle (the gather engine, at caps that hold every level, held
    to it level by level), the production caps' dropped sites, one train
    step at B=2 with its peak and ms."""
    from dal3d_tpu_torch.models.heads.mg_head import multi_group_predict
    from dal3d_tpu_torch.ops.nms import greedy_nms_from_iou
    from dal3d_tpu_torch.runtime.steps import make_predict_step, make_train_step
    from dal3d_tpu_torch.solver.optim import OneCycleSchedule, build_optimizer

    bundle = engine_bundle(engine_cfg(Config, "dense", dtype="float32"), sd)
    t0 = time.perf_counter()
    predict = make_predict_step(bundle)
    p_ms, out, runs, first_peak, peak = timed_runs(counters, lambda: predict(batch), DENSE_ITERS,
                                                   "dense predict")
    launches_p = main_path_launches(counters, "dense predict", runs,
                                    dict(iou_matrix=K2_PER_PREDICT))
    n_det = [int(x) for x in out["det_valid"].sum(1)]
    if min(n_det) == 0 or not bool(torch.isfinite(out["box3d_lidar"]).all()):
        fail(f"dense predict: detections {n_det}")
    print(f"dense predict (B={B}, f32): median {p_ms:.2f} ms over {DENSE_ITERS} -> "
          f"{B / p_ms * 1e3:.2f} scans/s; peak memory {peak:.2f} GB (first call, with the "
          f"autotuner's trials, {first_peak:.2f}); detections {n_det}; launches K2 "
          f"{launches_p['iou_matrix']} in {runs}, no other kernel (cuDNN's convs)")
    stage_split(bundle, batch, multi_group_predict, greedy_nms_from_iou, tiou)
    prof = device_profile(lambda: predict(batch), "dense predict", p_ms)
    stamp(t0, "dense: predicts timed, split, profile")

    # the oracle: the gather engine at caps that hold every level (the dense
    # engine's active sets give their sizes), held to the dense engine
    md = forward_maps(bundle, batch)
    counts = [(m[1] > 0).flatten(1).sum(1) for m in md["middle"]]
    full = tuple(-(-int(c.max()) // 128) * 128 for c in counts)
    dropped = [[max(0, int(n) - cap) for n in c.tolist()] for c, cap in zip(counts, GATHER_CAPS)]
    gather = engine_bundle(engine_cfg(Config, "gather", dtype="float32", voxel_caps=full), sd)
    mg = forward_maps(gather, batch)
    lv = levels_gap(mg["middle"], md["middle"])
    oracle = maps_gap(mg, md)
    if not all(a for a, _ in lv) or max(g for _, g in lv) > ORACLE_TOL or oracle > ORACLE_TOL:
        fail(f"the gather engine against the dense oracle: levels {lv}, maps {oracle:.2e}")
    print(f"dense oracle: the gather engine (phase 21's path, voxel caps {full}, which hold every "
          f"level: active sites {[c.tolist() for c in counts]}) against the dense engine on the "
          f"same weights: each level's active set equal, features within "
          f"{max(g for _, g in lv):.2e} of scale ({[f'{g:.1e}' for _, g in lv]}); dense, "
          f"embedding and 12 head maps within {oracle:.2e} (tol {ORACLE_TOL}); the production "
          f"caps {GATHER_CAPS} drop {dropped} sites per level and frame")
    del md, mg
    stamp(t0, "dense: the oracle")
    # one train step, timed alone: the 3D convs take cuDNN's heuristic choice,
    # which searches nothing, so a first step runs as a later one does (17751.9
    # and 17760 ms in PR 15's run); a warm-up step would double the 18 s
    train = dict(batch, gt_boxes=gt_np[0], gt_classes=gt_np[1])
    opt = build_optimizer(OneCycleSchedule(total_steps=100)).init(bundle.model.named_parameters())
    step = make_train_step(bundle, opt)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    logs = {k: float(v) for k, v in step(train).items()}
    torch.cuda.synchronize()
    t_ms = (time.perf_counter() - t1) * 1e3
    t_peak = torch.cuda.max_memory_allocated() / 1e9
    launches_t = main_path_launches(counters, "dense train step", 1, {})
    if not all(np.isfinite(v) for v in logs.values()):
        fail(f"dense train step logs {logs}")
    print(f"dense train step (B={B}, f32; each L0 unit and each stage recomputed in backward): "
          f"{t_ms:.2f} ms (one step, the first); peak memory {t_peak:.2f} GB; logs {logs}")
    del step, opt, bundle, predict
    torch.cuda.empty_cache()
    return dict(predict_ms=p_ms, launches_predict=launches_p, launches_train=launches_t,
                peak=peak, first_peak=first_peak, oracle=oracle, levels=lv, counts=counts,
                dropped=dropped, step_ms=t_ms, step_peak=t_peak, gather=gather,
                busy=sum(v[0] for v in prof.values()))


def sorted_engine(gather, batch, counters) -> dict:
    """The searchsorted engine at full width on phase 3's voxels: every
    level's subm rulebook and downsample output set against the grid
    engine's as sets (each output cell's input cells per tap), then the
    gather backbone's 21 convs on the sorted plans (K4) against the grid
    plans' map."""
    from dal3d_tpu_torch.models.backbones.scn import sorted_forward
    from dal3d_tpu_torch.ops import sparse as ss
    from dal3d_tpu_torch.ops import sparse_backend as sp
    from dal3d_tpu_torch.runtime.steps import autotuned_convs, model_inputs

    backbone = gather.model.backbone
    inputs = model_inputs(batch, gather.device)
    vox = (inputs["vf"], inputs["vc"], inputs["vv"])
    srt, grd = ss.from_voxels(*vox, backbone.sparse_shape), sp.from_voxels(*vox, backbone.sparse_shape)

    def neighbours(lin, idx, hit, sentinel):
        """[B, K, M] input cells of each (tap, output row), sentinel = none."""
        src = torch.gather(lin.long(), 1, idx.long().reshape(B, -1)).view(idx.shape)
        return torch.where(hit, src, sentinel)

    t0 = time.perf_counter()
    sizes = []
    for level in (backbone.l0, backbone.stage1, backbone.stage2, backbone.stage3):
        d = level.down
        n_in = int(np.prod(srt.shape))
        rs, rg = ss.subm_rulebook(srt, 3), sp.subm_rulebook(grd, 3)
        order = torch.argsort(grd.lin.long(), dim=1)
        ng = torch.gather(neighbours(grd.lin, *rg, n_in), 2,
                          order[:, None, :].expand(-1, rs[0].shape[1], -1))
        if not torch.equal(torch.sort(grd.lin, 1)[0], srt.lin) or not torch.equal(
                neighbours(srt.lin, *rs, n_in), ng):
            fail(f"sorted engine: a subm rulebook differs from the grid engine's as a set")
        sd = ss.downsample_plan(srt, d.kernel_size, d.stride, d.padding, d.out_cap)
        gd = sp.downsample_plan(grd, d.kernel_size, d.stride, d.padding, d.out_cap)
        if not torch.equal(sd[0], gd[0]) or not torch.equal(neighbours(srt.lin, sd[1], sd[2], n_in),
                                                            neighbours(grd.lin, gd[1], gd[2], n_in)):
            fail(f"sorted engine: a downsample plan differs from the grid engine's as a set")
        sizes.append(int((sd[0] < int(np.prod(sd[3]))).sum()))
        srt = ss.SparseBatch(features=srt.features[:, :1], lin=sd[0], shape=sd[3])
        grd = sp.SparseBatch(features=grd.features[:, :1], lin=gd[0], shape=gd[3])
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    for c in counters:
        c.launches = 0
    with torch.inference_mode(), autotuned_convs():
        got, _ = sorted_forward(backbone, *vox)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in counters}
        want, _ = backbone(*vox)
    gap = float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)
    if launches.get("gather_gemm") != K4_PER_PREDICT or gap > SORTED_TOL:
        fail(f"sorted engine: launches {launches}, BEV map {gap:.2e} of scale")
    print(f"sorted engine (full width, phase 3's voxels): rulebooks and downsample output sets "
          f"of all 4 levels equal to the grid engine's as sets ({sizes} output sites, "
          f"{plan_s:.2f} s to build and compare); the gather backbone's "
          f"{launches['gather_gemm']} convs on the sorted plans (K4) give the grid plans' BEV "
          f"map within {gap:.1e} of scale")
    return dict(launches=launches, gap=gap, sizes=sizes)


def hybrid_cli(tmp: str) -> dict:
    """A config that imports configs/cbgs_entropy_synthetic.py and sets
    impl="hybrid", through ``train`` and ``active_select --checkpoint`` on 8
    synthetic frames. Returns seconds per CLI."""
    from dal3d_tpu_torch.runtime.checkpoint import latest_epoch
    from dal3d_tpu_torch.tools import active_select, create_data, train
    from dal3d_tpu_torch.utils.fileio import load

    base = os.path.join(tmp, "cbgs_hybrid_cli")
    os.makedirs(base)
    cfg = os.path.join(base, "cbgs_hybrid_synthetic.py")
    with open(cfg, "w") as f:
        f.write(f"import copy\nimport sys\nsys.path.insert(0, {os.path.join(ROOT, 'configs')!r})\n"
                "from cbgs_entropy_synthetic import *  # noqa: F401,F403\n"
                "model = copy.deepcopy(model)\nmodel['backbone']['impl'] = 'hybrid'\n"
                "selector = dict(selector, buffer_file='data/buffers/synthetic_hybrid.json')\n"
                "work_dir = './work_dirs/cbgs_hybrid_synthetic'\n")
    cwd = os.getcwd()
    os.chdir(base)
    seconds = {}
    try:
        create_data.main(["synthetic_data_prep", "--root_path", "data/synthetic", "--n_frames",
                          "8", "--n_logs", "2", "--range_xy", "7"])
        t0 = time.perf_counter()
        tr = train.main([cfg, "--seed", "0", "--epochs", "1", "--no_validate"])
        seconds["train"] = time.perf_counter() - t0
        active_select.main([cfg])  # writes the empty buffer
        t0 = time.perf_counter()
        active_select.main([cfg, "--checkpoint", "work_dirs/cbgs_hybrid_synthetic"])
        seconds["active_select --checkpoint"] = time.perf_counter() - t0
        picked = load("data/buffers/synthetic_hybrid.json")
        subset = load("data/synthetic/infos_train_10sweeps_withvelo_3.pkl")
        infos = load("data/synthetic/infos_train_10sweeps_withvelo.pkl")
        epoch = latest_epoch("work_dirs/cbgs_hybrid_synthetic")
    finally:
        os.chdir(cwd)
    if (tr.bundle.model.backbone.impl != "hybrid" or epoch != 1 or not picked.get("3")
            or [i["token"] for i in subset] != [infos[k]["token"] for k in picked["3"]]):
        fail(f"the hybrid CLI round: engine {tr.bundle.model.backbone.impl}, epoch {epoch}, "
             f"buffer {picked}")
    print(f"  a config importing cbgs_entropy_synthetic.py with impl='hybrid' on 8 synthetic "
          "frames: " + "; ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
          + f"; the buffer {picked}")
    return seconds


def engines_phase(tmp: str, Config, counters, tg, bd, tiou) -> dict:
    """Phase 22: the brick, hybrid and dense engines and the searchsorted
    engine at full width on phase 3's voxels (B=2), one seeded state dict
    for every engine; then a hybrid config through the CLIs. Returns each
    kernel's launches over the new main paths, and the numbers."""
    from dal3d_tpu_torch.models.builder import build_detector

    t_phase = time.perf_counter()
    cfg = Config.fromfile(os.path.join(ROOT, "configs", "cbgs_spatial_temporal.py"))
    sd = build_detector(cfg, seed=0).model.state_dict()
    vf, vc, vv, n_vox = make_batch(0, cfg)
    batch16 = {"voxel_features": torch.from_numpy(vf).to(torch.bfloat16),
               "voxel_coords": torch.from_numpy(vc), "voxel_valid": torch.from_numpy(vv)}
    batch32 = dict(batch16, voxel_features=torch.from_numpy(vf))
    gt_np = random_gt(cfg, np.random.RandomState(22), B, 8, 45.0)
    gt = ([torch.from_numpy(x).cuda() for x in gt_np[0]],
          [torch.from_numpy(x).cuda() for x in gt_np[1]])
    print(f"the other engines: phase 3's voxels {n_vox}, one seeded state dict for every engine")
    brick = brick_engine(Config, sd, batch16, gt, gt_np, counters, tg, bd, tiou)
    t_brick = time.perf_counter() - t_phase
    hybrid = hybrid_engine(Config, sd, batch32, gt, gt_np, counters, tg, bd, tiou)
    t_hybrid = time.perf_counter() - t_phase - t_brick
    dense = dense_engine(Config, sd, batch32, gt_np, counters, tiou)
    srt = sorted_engine(dense.pop("gather"), batch32, counters)
    torch.cuda.empty_cache()
    t_dense = time.perf_counter() - t_phase - t_brick - t_hybrid
    cli_s = hybrid_cli(tmp)
    print(f"phase 22 (the other engines): {time.perf_counter() - t_phase:.1f} s (brick "
          f"{t_brick:.1f}, hybrid {t_hybrid:.1f}, dense + oracle + sorted {t_dense:.1f})")
    return dict(brick=brick, hybrid=hybrid, dense=dense, sorted=srt, cli_s=cli_s)


# ---------------------------------------------------------------------------
# phase 23: the gather and hybrid engines in bf16: K4 and K4-dW in bf16 (B.1, A9.d.5)
# ---------------------------------------------------------------------------
BF16_ULP = 2.0 ** -7  # one bf16 ulp at the output's scale: every bf16 K4 / dX / K4-dW launch
BF16_MAP_TOL = 5e-2  # phase 5's bf16 gate: the bf16 maps against phase 21's f32 maps


def gemm_bf16_bound_ms(features, plan, w) -> tuple:
    """Least time (ms) of one bf16 K4 launch over its plan: the bytes (bf16
    rows and weights, the rulebook and order read once, the bf16 output
    written once) or 2 * hits * Cin * Cout at the bf16 tensor-core peak,
    whichever is larger; and which."""
    Bt, _, Cin = features.shape
    M, Cout = plan.rulebook.shape[2], w.shape[-1]
    nbytes = ((features.numel() + w.numel() + Bt * M * Cout) * 2 + plan.rulebook.numel() * 4
              + (plan.order.numel() * 8 if plan.order is not None else 0))
    ops = 2.0 * int((plan.rulebook >= 0).sum()) * Cin * Cout
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_BF16 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def dw_bf16_bound_ms(features, plan, g) -> tuple:
    """Least time (ms) of one bf16 K4-dW launch: the bytes (bf16 features
    and g, the rulebook and order read once, the bf16 dW written once) or
    2 * hits * Cin * Cout at the bf16 tensor-core peak."""
    K, Cin, Cout = plan.rulebook.shape[1], features.shape[-1], g.shape[-1]
    nbytes = ((features.numel() + g.numel() + K * Cin * Cout) * 2 + plan.rulebook.numel() * 4
              + (plan.order.numel() * 8 if plan.order is not None else 0))
    ops = 2.0 * int((plan.rulebook >= 0).sum()) * Cin * Cout
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_BF16 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def library_gemm_over_plan(features, plan, w):
    """Yardstick the port never calls: one index_select of every (row, tap)
    feature row, then one cuBLAS matmul [B*M, K*Cin] x [K*Cin, Cout] in the
    features' type (JAX's einsum over (k, c))."""
    Bt, N, Cin = features.shape
    rb = plan.rulebook
    K, M = rb.shape[1], rb.shape[2]
    flat = torch.cat([features.reshape(Bt * N, Cin), features.new_zeros(1, Cin)])
    base = (torch.arange(Bt, device=rb.device) * N)[:, None, None]
    sel = torch.where(rb >= 0, rb.long() + base, Bt * N).transpose(1, 2).reshape(-1)
    wk = w.reshape(K * Cin, -1)

    def run():
        return flat.index_select(0, sel).view(Bt * M, K * Cin) @ wk

    return run


def hold_bf16(tag: str, k4=(), dw=(), k4_repeat: bool = False) -> dict:
    """Every captured bf16 K4 launch (forward and input gradient) and K4-dW
    launch against its plain version over the same plan (f32 sums, one
    rounding) within one bf16 ulp of scale, each K4-dW launch bit-equal on a
    repeat, and with ``k4_repeat`` each K4 launch too. Returns {kernel:
    (launches, max error relative to scale, max absolute error)}."""
    from dal3d_tpu_torch.ops import gather as tg

    def err(got, ref):
        e = float((got.float() - ref.float()).abs().max())
        return e / max(float(ref.float().abs().max()), 1e-30), e

    with torch.no_grad():
        e4, ew, rep4, repw = [], [], True, True
        for f, p, w in k4:
            got = tg._launch_gemm(f, p, w)
            e4.append(err(got, gemm_plain_over_plan(tg, f, p, w)))
            if k4_repeat:
                rep4 &= torch.equal(got, tg._launch_gemm(f, p, w))
        for f, p, g in dw:
            got = tg._launch_dw(f, p, g)
            ew.append(err(got, dw_plain_over_plan(tg, f, p, g)))
            repw &= torch.equal(got, tg._launch_dw(f, p, g))
    r4, rw = max(e4, default=(0.0, 0.0)), max(ew, default=(0.0, 0.0))
    if max(r4[0], rw[0]) > BF16_ULP or not (rep4 and repw):
        fail(f"{tag}: a bf16 K4 launch {r4[0]:.2e} or K4-dW launch {rw[0]:.2e} of scale from "
             f"its plain version (tol {BF16_ULP:.2e}), repeat bit-equal K4 {rep4} K4-dW {repw}")
    out = {"gather_gemm_bf16": (len(e4), r4[0], max((e[1] for e in e4), default=0.0)),
           "gather_dw_bf16": (len(ew), rw[0], max((e[1] for e in ew), default=0.0))}
    print(f"{tag}: every bf16 launch against its plain version (tol {BF16_ULP:.2e} of scale): "
          + ", ".join(f"{k} {n} within {e:.1e} ({a:.2e} absolute)" for k, (n, e, a) in out.items()
                      if n)
          + (f"; every {'K4 and ' if k4_repeat else ''}K4-dW launch bit-equal on a repeat"
             if k4_repeat or dw else ""))
    return out


def bf16_k4_times(tg, calls) -> dict:
    """One predict's bf16 K4 launches timed (device ms), each beside the f32
    K4 on the same plan (the same values in f32), its plain version, the
    index_select + matmul yardstick and its bound; summed per predict."""
    tot = dict(ms=0.0, f32_ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, t_bytes=0.0,
               t_ops=0.0, hits=0, walked=0, walked_f32=0)
    rows = []
    with torch.no_grad():
        for f, p, w in calls:
            # the (row, tap) pairs that gemm_walk, the launch arithmetic's
            # model of the kernels' walks, has the bf16 kernel multiply
            # (64-row warpgroup groups) and the f32 one (16- or 32-row warp
            # groups), against the hits; the model's tiles held to the build
            Cout = w.shape[-1]
            built = (tg.built_bf16_tile(0, tg._cout_pad(Cout)),
                     tg.built_bf16_tile(1, tg._cout_pad(Cout)))
            if tg.gemm_tile_rows(Cout, True) != built:
                fail(f"gemm_tile_rows({Cout}, bf16) {tg.gemm_tile_rows(Cout, True)} is not the "
                     f"built kernel's tile {built}")
            tot["hits"] += int((p.rulebook >= 0).sum())
            tot["walked"] += int(tg.gemm_walk(p, Cout, True)[1].sum()) * built[1]
            tot["walked_f32"] += (int(tg.gemm_walk(p, Cout)[1].sum())
                                  * tg.gemm_tile_rows(Cout)[1])
            f32, w32 = f.float(), w.float()
            ms = cuda_time_ms(lambda: tg._launch_gemm(f, p, w), 5)
            ms32 = cuda_time_ms(lambda: tg._launch_gemm(f32, p, w32), 5)
            pms = cuda_time_ms(lambda: gemm_plain_over_plan(tg, f, p, w), 2)
            lms = cuda_time_ms(library_gemm_over_plan(f, p, w), 2)
            bms, by = gemm_bf16_bound_ms(f, p, w)
            for k, v in (("ms", ms), ("f32_ms", ms32), ("plain_ms", pms), ("library_ms", lms),
                         ("bound_ms", bms), ("t_bytes" if by == "bytes" else "t_ops", bms)):
                tot[k] += v
            rows.append((tuple(f.shape), tuple(w.shape), int((p.rulebook >= 0).sum()), ms, ms32,
                         pms, lms, bms, by))
    print("  bf16 K4 launches of one predict (device ms: bf16 kernel | f32 kernel on the same "
          "plan | plain | index_select + matmul | bound):")
    for fs, ws, hits, ms, ms32, pms, lms, bms, by in rows:
        print(f"    features {fs} w {ws} hits {hits}: {ms:.4f} | {ms32:.4f} | {pms:.3f} | "
              f"{lms:.3f} | {bms:.4f} ({by})")
    tot["bound_by"] = "bytes" if tot["t_bytes"] >= tot["t_ops"] else "operations"
    print(f"  bf16 K4 walk over the predict's plans, as gemm_walk models it (tiles held to the "
          f"build; not counted by the kernel): {tot['walked']} (row, tap) pairs in 64-row "
          f"warpgroup groups against {tot['hits']} hits ({tot['walked'] / tot['hits']:.3f}x); "
          f"the f32 kernel's 16- / 32-row groups {tot['walked_f32']} "
          f"({tot['walked_f32'] / tot['hits']:.3f}x)")
    print(f"  bf16 K4 per predict: {tot['ms']:.3f} ms, f32 K4 on the same plans "
          f"{tot['f32_ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, library "
          f"{tot['library_ms']:.3f} ms, bound {tot['bound_ms']:.4f} ms ({tot['bound_by']})")
    return tot


def bf16_dw_times(tg, calls) -> dict:
    """One train step's bf16 K4-dW launches timed (device ms) beside their
    plain version, the index_select + bmm yardstick and their bound, summed
    per step."""
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, t_bytes=0.0, t_ops=0.0)
    with torch.no_grad():
        for f, p, g in calls:
            tot["ms"] += cuda_time_ms(lambda: tg._launch_dw(f, p, g), 5)
            tot["plain_ms"] += cuda_time_ms(lambda: dw_plain_over_plan(tg, f, p, g), 2)
            tot["library_ms"] += cuda_time_ms(library_gather_dw(f, p, g), 2)
            bms, by = dw_bf16_bound_ms(f, p, g)
            tot["bound_ms"] += bms
            tot["t_bytes" if by == "bytes" else "t_ops"] += bms
    tot["bound_by"] = "bytes" if tot["t_bytes"] >= tot["t_ops"] else "operations"
    print(f"  bf16 K4-dW per train step ({len(calls)} launches): {tot['ms']:.3f} ms, plain "
          f"{tot['plain_ms']:.3f} ms, index_select + bmm {tot['library_ms']:.3f} ms, bound "
          f"{tot['bound_ms']:.4f} ms ({tot['bound_by']})")
    return tot


def bf16_engine(impl: str, Config, ref: dict, gt_np, counters, tg, bd, tiou,
                times: bool) -> dict:
    """The CBGS model on one engine in bf16 (voxel caps GATHER_CAPS) with
    phase 21's weights and voxels: every bf16 K4 launch of a predict held
    against its plain version (and, with ``times``, timed beside the f32 K4
    on the same plans), ENGINE_ITERS timed predicts with their launches, the
    maps against phase 21's f32 maps, the detections under phase 5's loose
    match against the plain versions' and the f32 model's; every K4 / dX /
    K4-dW launch of a train step held, ENGINE_TRAIN_ITERS timed steps."""
    from dal3d_tpu_torch.models.heads.mg_head import multi_group_predict
    from dal3d_tpu_torch.ops.nms import greedy_nms_from_iou
    from dal3d_tpu_torch.runtime.steps import make_predict_step, make_train_step
    from dal3d_tpu_torch.solver.optim import OneCycleSchedule, build_optimizer

    tag = f"bf16 {impl}"
    t0 = time.perf_counter()
    bundle = engine_bundle(engine_cfg(Config, impl, dtype="bfloat16", voxel_caps=GATHER_CAPS),
                           ref["sd"])
    if bundle.model.backbone.l0.stem.dtype != torch.bfloat16:
        fail(f"{tag}: the backbone runs in {bundle.model.backbone.l0.stem.dtype}")
    batch = ref["batch"]
    predict = make_predict_step(bundle)
    n4 = K4_PER_PREDICT if impl == "gather" else K4_PER_HYBRID
    with Capture(tg, "_launch_gemm") as k4, Capture(tiou, "iou_matrix") as k2:
        predict(batch)
        torch.cuda.synchronize()
    if (len(k4.calls), len(k2.calls)) != (n4, K2_PER_PREDICT) or any(
            f.dtype != torch.bfloat16 for f, _, _ in k4.calls):
        fail(f"{tag} predict launched K4 {len(k4.calls)}x, K2 {len(k2.calls)}x")
    held_p = hold_bf16(f"{tag} predict", k4.calls, k4_repeat=True)
    k4_times = bf16_k4_times(tg, k4.calls) if times else None
    del k4, k2
    stamp(t0, f"{tag}: a predict's launches held" + (" and timed" if times else ""))
    p_ms, out, runs, first_peak, peak = timed_runs(counters, lambda: predict(batch), ENGINE_ITERS,
                                                   f"{tag} predict")
    launches_p = main_path_launches(counters, f"{tag} predict", runs,
                                    dict(gather_gemm_bf16=n4, iou_matrix=K2_PER_PREDICT))
    n_det = [int(x) for x in out["det_valid"].sum(1)]
    if min(n_det) == 0 or not bool(torch.isfinite(out["box3d_lidar"]).all()):
        fail(f"{tag} predict: detections {n_det}")
    mk = maps_cpu(forward_maps(bundle, batch))
    gap = maps_gap(mk, ref["maps"])
    if not gap <= BF16_MAP_TOL:
        fail(f"{tag} maps {gap:.2e} of scale from phase 21's f32 maps (tol {BF16_MAP_TOL})")
    _, plain_out = plain_predict(bundle, predict, batch, tg, bd, tiou)
    out_cpu = {k: v.cpu() for k, v in out.items()}
    m_plain = loose_matches(out_cpu, {k: v.cpu() for k, v in plain_out.items()})
    m_f32 = loose_matches(out_cpu, ref["out"])
    del mk, plain_out
    print(f"{tag} predict (B={B}): median {p_ms:.2f} ms over {ENGINE_ITERS} -> "
          f"{B / p_ms * 1e3:.2f} scans/s; peak memory {peak:.2f} GB (first call "
          f"{first_peak:.2f}); detections {n_det}; launches bf16 K4 "
          f"{launches_p['gather_gemm_bf16']} K2 {launches_p['iou_matrix']} in {runs}, no f32 "
          f"K4; dense, embedding and 12 head maps within {gap:.2e} of scale of phase 21's f32 "
          f"maps (tol {BF16_MAP_TOL}); detections under phase 5's loose match: {m_plain[0]} of "
          f"{m_plain[1]} against the plain versions' bf16 predict, {m_f32[0]} of {m_f32[1]} "
          f"against the f32 model's")
    stage_split(bundle, batch, multi_group_predict, greedy_nms_from_iou, tiou)
    prof = device_profile(lambda: predict(batch), f"{tag} predict", p_ms)
    stamp(t0, f"{tag}: predicts timed, maps, split, profile")

    train = dict(batch, gt_boxes=gt_np[0], gt_classes=gt_np[1])
    opt = build_optimizer(OneCycleSchedule(total_steps=100)).init(bundle.model.named_parameters())
    step = make_train_step(bundle, opt)
    with Capture(tg, "_launch_gemm") as k4, Capture(tg, "_launch_dw") as kdw:
        step(train)
        torch.cuda.synchronize()
    n_dx = len(k4.calls) - n4
    if (n_dx, len(kdw.calls)) != (n4 - 1, n4):  # the stem's voxel features need no dX
        fail(f"{tag} train step launched {n_dx} K4 input gradients and {len(kdw.calls)} K4-dW")
    held_t = hold_bf16(f"{tag} train step", k4.calls, kdw.calls)
    dw_times = bf16_dw_times(tg, kdw.calls) if times else None
    del k4, kdw, step, opt
    tr = engine_train(bundle, batch, gt_np, counters,
                      dict(gather_gemm_bf16=n4 + n_dx, gather_dw_bf16=n4), f"{tag} train step")
    stamp(t0, f"{tag}: train steps held, timed, split, profile")
    del bundle, predict
    torch.cuda.empty_cache()
    return dict(predict_ms=p_ms, launches_predict=launches_p, launches_train=tr["launches"],
                train=tr, held=(held_p, held_t), map_gap=gap, k4_times=k4_times,
                dw_times=dw_times, peak=peak, busy=sum(v[0] for v in prof.values()),
                loose=(m_plain, m_f32))


def bf16_engines_phase(Config, counters, tg, bd, tiou, ref: dict) -> dict:
    """Phase 23: configs/cbgs_spatial_temporal.py on the gather engine and
    on the hybrid engine at dtype="bfloat16" (B=2, phase 21's voxels and
    weights): predicts and train steps, every bf16 K4 / dX / K4-dW launch
    against its plain version, the maps against phase 21's f32 maps, the
    bf16 K4 beside the f32 K4 on the same rulebooks. Returns each kernel's
    launches over the four main paths, and the numbers."""
    t_phase = time.perf_counter()
    gt_np = random_gt(Config.fromfile(os.path.join(ROOT, "configs", "cbgs_spatial_temporal.py")),
                      np.random.RandomState(23), B, 8, 45.0)
    gather = bf16_engine("gather", Config, ref, gt_np, counters, tg, bd, tiou, True)
    hybrid = bf16_engine("hybrid", Config, ref, gt_np, counters, tg, bd, tiou, False)
    print(f"phase 23 (the gather and hybrid engines in bf16): "
          f"{time.perf_counter() - t_phase:.1f} s")
    return dict(gather=gather, hybrid=hybrid)


# ---------------------------------------------------------------------------
# phase 24: data parallel on the one card (torch.distributed): a world of 1 on
# NCCL, a world of 2 on gloo
# ---------------------------------------------------------------------------
DP_WORLD = 2  # ranks spawned on the one card
DP_TIMED = 3  # timed steps and reductions a rank
F32_NUDGE = 2.0 ** -23  # one f32 ulp: the rounding floor's perturbation of the features


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def f32_backbone(path: str):
    """The config at ``path`` with its backbone in f32 (as phase 17's
    ``cfg32``): the rounding floor of a step is then far below bf16's, so
    that a gate at twice it can fail."""
    from dal3d_tpu_torch.utils.config import Config

    cfg = Config.fromfile(path)
    cfg["model"] = dict(cfg["model"], backbone=dict(cfg["model"]["backbone"], dtype="float32"))
    return cfg


def pinned_convs():
    """The port's steps on cuDNN's heuristic choice among deterministic
    algorithms (TF32 off) in place of its autotuner, whose timings may pick
    other plans in other processes: the same plans in every process.
    PyTorch keys its plan cache by the deterministic flag too, so these
    plans neither reuse nor replace the autotuned ones of the same shapes."""
    from dal3d_tpu_torch.runtime import steps

    return mock.patch.object(steps, "autotuned_convs", lambda: torch.backends.cudnn.flags(
        enabled=True, benchmark=False, deterministic=True, allow_tf32=False))


def dp_step(cfg, batch) -> dict:
    """One train step of the production CBGS model with seeded weights (seed
    0, as phase 11's repeated batch starts from) on ``batch``, on the card:
    logs, the (reduced) gradients, the update and the state after it (on the
    host)."""
    from dal3d_tpu_torch.models.builder import build_detector
    from dal3d_tpu_torch.runtime.steps import make_train_step
    from dal3d_tpu_torch.solver.optim import OneCycleSchedule, build_optimizer

    bundle = build_detector(cfg, seed=0)
    before = {k: v.detach().cpu().clone() for k, v in bundle.model.state_dict().items()}
    opt = build_optimizer(OneCycleSchedule(total_steps=200)).init(bundle.model.named_parameters())
    step = make_train_step(bundle, opt)
    logs = step(batch)
    torch.cuda.synchronize()
    state = {k: v.detach().cpu().clone() for k, v in bundle.model.state_dict().items()}
    return dict(logs={k: float(v) for k, v in logs.items()},
                grads={n: p.grad.detach().cpu().clone() for n, p in opt.params.items()},
                update={n: state[n] - before[n] for n in opt.params},
                stats={k: v for k, v in state.items() if "running" in k},
                state=state, bundle=bundle, opt=opt, step=step)


def permute_frames(batch: dict, order: list) -> dict:
    """``batch`` with its frames in ``order``: every per-frame array, the
    per-task lists element by element."""
    def rows(v):
        if isinstance(v, (np.ndarray, torch.Tensor)):
            return v[order]
        if isinstance(v, list):
            return [rows(x) for x in v]
        return v

    return {k: rows(v) for k, v in batch.items()}


def dp_reference(cfg32, batch: dict, count) -> tuple:
    """The no-group f32 step on the global ``batch`` and its rounding floor
    against the world's step: for the gradient, the running statistics and
    AdamW's update, the largest gap that one of three perturbations of the
    same step makes, each a freedom the world's ranks have: the features
    moved by one f32 ulp; the frames in another order (the batch's sums in
    another order, as the ranks' partial sums are); cuDNN's convs on its
    heuristic choice in place of the autotuner's (the ranks autotune their
    own plans at their own batch size). Returns (the step, the floors, the
    gaps of each perturbation)."""
    parts = ("grads", "stats", "update")
    ref = {k: v for k, v in count(dp_step, cfg32, batch).items() if k in parts + ("logs",)}
    torch.cuda.empty_cache()

    def gaps(other: dict) -> dict:
        torch.cuda.empty_cache()
        return {p: dp_gap(ref[p], other[p]) for p in parts}

    vf = torch.as_tensor(batch["voxel_features"])
    noise = 1.0 + F32_NUDGE * torch.randn(vf.shape, generator=torch.Generator().manual_seed(24))
    n = vf.shape[0]
    by_kind = {}
    # in f32: the loader ships bf16 features, which would round the nudge away
    by_kind["one f32 ulp"] = gaps(count(dp_step, cfg32,
                                        dict(batch, voxel_features=vf.float() * noise)))
    by_kind["frames reordered"] = gaps(count(
        dp_step, cfg32, permute_frames(batch, list(range(n // 2, n)) + list(range(n // 2)))))
    with pinned_convs():
        by_kind["cuDNN heuristic"] = gaps(count(dp_step, cfg32, batch))
    torch.cuda.empty_cache()
    floors = {p: max(g[p] for g in by_kind.values()) for p in parts}
    return ref, floors, by_kind


def same_bits(a: dict, b: dict) -> bool:
    """Two steps' logs, gradients and states equal bit for bit."""
    return (a["logs"] == b["logs"]
            and all(torch.equal(a[p][k], b[p][k]) for p in ("grads", "state") for k in a[p]))


def dp_rank(rank: int, world: int, job: dict) -> None:
    """A rank of the world of ``world`` gloo processes on card 0: the
    production CBGS step on its rows of phase 11's 4 frames (held to the
    per-step launch counts), its timed steps and gradient reductions, then
    active_select on phase 7's pool, dist_test on that pool (cuDNN's choice
    pinned) and on the overfit twin's scene (a frame a rank) and an epoch
    of train_bevfusion on phase 15's set.
    Writes what it saw to ``job["out"]``-<rank>.pkl; a failure raises and
    fails the run."""
    import torch.distributed as dist

    from dal3d_tpu_torch.ops import banded as bd
    from dal3d_tpu_torch.ops import gather as tg
    from dal3d_tpu_torch.ops import iou_matrix as tiou
    from dal3d_tpu_torch.ops import lsa as tl
    from dal3d_tpu_torch.parallel.dist import GROUP_TIMEOUT
    from dal3d_tpu_torch.parallel.mesh import all_reduce_gradients, shard_batch
    from dal3d_tpu_torch.tools import active_select, dist_test, train_bevfusion

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{job['rendezvous']}", rank=rank,
                            world_size=world, timeout=GROUP_TIMEOUT)
    counters = (bd.banded_conv, bd.banded_dw, tiou.iou_matrix, tg.gather_gemm, tg.gather_rows,
                tg.gather_dw, tl.linear_sum_assignment)
    out = {}
    try:
        batch = shard_batch(torch.load(job["batch"], weights_only=False), rank, world)
        for c in counters:
            c.launches = 0
        r = dp_step(f32_backbone(job["cfg_train"]), batch)
        out["launches_step"] = {c.__name__: c.launches for c in counters}
        out.update({k: r[k] for k in ("logs", "grads", "update", "stats")})
        step, opt = r["step"], r["opt"]
        ms, red = [], []
        for i in range(DP_TIMED + 1):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(batch)
            torch.cuda.synchronize()
            if i:
                ms.append((time.perf_counter() - t0) * 1e3)
        for _ in range(DP_TIMED):
            dist.barrier()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev[0].record()
            all_reduce_gradients(opt.params.values())
            ev[1].record()
            torch.cuda.synchronize()
            red.append(((time.perf_counter() - t0) * 1e3, ev[0].elapsed_time(ev[1])))
        out["step_ms"], out["reduce_ms"] = ms, red
        out["grad_bytes"] = sum(p.numel() * 4 for p in opt.params.values())
        del r, step, opt, batch
        torch.cuda.empty_cache()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        active_select.main([job["cfg_select"], "--checkpoint", job["work_select"],
                            "--seed", "3407"])
        with pinned_convs():
            dist_test.main([job["cfg_select"], "--checkpoint", job["work_select"], "--out",
                            job["dets_pool"], "--work_dir", os.path.dirname(job["dets_pool"])])
        dist_test.main([job["cfg_twin"], "--checkpoint", job["work_twin"], "--out", job["dets"],
                        "--work_dir", os.path.dirname(job["dets"]), "--batch_size",
                        str(world)])
        torch.cuda.synchronize()
        out["select_s"] = time.perf_counter() - t0
        out["launches_select"] = {c.__name__: c.launches for c in counters}
        torch.cuda.empty_cache()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        res = train_bevfusion.main([job["cfg_bev"], "--epochs", "1", "--budget", job["budget"]])
        torch.cuda.synchronize()
        out["bev_s"] = time.perf_counter() - t0
        out["launches_bev"] = {c.__name__: c.launches for c in counters}
        out["bev_steps"], out["bev_logs"] = res["optimizer"].count, res["logs"]
    finally:
        dist.destroy_process_group()
    with open(f"{job['out']}-{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def dp_gap(ref: dict, got: dict) -> float:
    """|got - ref| / |ref| over the tensors of ``ref``."""
    return _grad_gap({k: v.float() for k, v in ref.items()}, {k: got[k].float() for k in ref})


def data_parallel_phase(tmp: str, train_paths: dict, loop: dict, twin: dict, counters) -> dict:
    """Phase 24. (a) A world of 1 on NCCL, started by ``init_dist`` from
    torchrun's variables: phase 11's production train step bit-equal to the
    step with no group, and ``train`` for an epoch whose checkpoint loads
    with no group. (b) A world of DP_WORLD gloo processes on this one card
    (NCCL refuses two ranks on one device): the step with its backbone in
    f32 and 2 frames a rank against the no-group step on the 4 frames (the
    gradient, the running statistics and AdamW's update within twice their
    rounding floor, ``dp_reference``), K1 78 and K3 21 launches a rank;
    active_select on phase 7's pool and checkpoint (one sweep a frame)
    with its files byte-equal to the one-process run's; dist_test on that
    pool at full width, 2 frames a rank as one process forwards them, with
    cuDNN's choice pinned in both
    (``pinned_convs``: phase 7's random weights decode thousands of
    near-tied boxes, whose NMS a rounding gap between two processes'
    autotuned choices flips), and on the overfit twin's checkpoint and
    2-frame scene (a frame a rank), each with its detections equal as sets
    to the one-process run's; an epoch of train_bevfusion on phase 15's set
    with phase 18's launches a step and finite losses.
    Returns the launches of each kernel over the phase."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from dal3d_tpu_torch.data import DataLoader, NuScenesDataset
    from dal3d_tpu_torch.models.builder import build_detector, loader_voxelize_cfg
    from dal3d_tpu_torch.parallel.dist import get_dist_info, init_dist
    from dal3d_tpu_torch.runtime import checkpoint as ckpt
    from dal3d_tpu_torch.tools import active_select, dist_test, train
    from dal3d_tpu_torch.utils.config import Config
    from dal3d_tpu_torch.utils.fileio import dump, load

    t_phase = time.perf_counter()
    base = os.path.join(tmp, "data_parallel")
    os.makedirs(base)
    launches = {c.__name__: 0 for c in counters}

    def count(fn, *a):
        for c in counters:
            c.launches = 0
        r = fn(*a)
        torch.cuda.synchronize()
        for c in counters:
            launches[c.__name__] += c.launches
        return r

    # phase 11's labeled set through its train pipeline: 4 frames
    cfg = Config.fromfile(train_paths["cfg"])
    train_data = dict(cfg["data"]["train"])
    dataset = NuScenesDataset(
        info_path=train_paths["info"], root_path="", nsweeps=train_data.get("nsweeps", 10),
        class_names=train_data.get("class_names"),
        pipeline=[dict(s) for s in train_data.get("pipeline", [])],
        tasks=[dict(t) for t in cfg["tasks"]], max_points=cfg.get("max_points", 300000),
        voxelize_host=loader_voxelize_cfg(cfg))
    np.random.seed(5)
    batch4 = next(iter(DataLoader(dataset, 2 * DP_WORLD, shuffle=False, prefetch=0)))
    batch4 = {k: v for k, v in batch4.items() if k != "metadata"}
    batch_path = os.path.join(base, "batch4.pt")
    torch.save(batch4, batch_path)
    from dal3d_tpu_torch.parallel.mesh import shard_batch

    batch2 = shard_batch(batch4, 0, DP_WORLD)

    # (a) a world of 1 on NCCL ------------------------------------------------
    ref_a = count(dp_step, cfg, batch2)
    again = count(dp_step, cfg, batch2)
    repeat_bits = same_bits(ref_a, again)
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()))
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        if init_dist("nccl") != (0, 1) or not dist.is_initialized():
            fail(f"init_dist from torchrun's variables: {get_dist_info()}, group "
                 f"{dist.is_initialized()}")
        backend = dist.get_backend()
        one = count(dp_step, cfg, batch2)
        world1_bits = same_bits(one, ref_a)
        gaps = {p: dp_gap(ref_a[p], one[p]) for p in ("grads", "update", "stats")}
        if repeat_bits and not world1_bits:
            fail(f"a world of 1 ({backend}): the step differs from the step with no group, "
                 f"which repeats bit for bit; gaps {gaps}")
        if not repeat_bits and not all(v <= 2 * dp_gap(ref_a[p], again[p]) for p, v in
                                       gaps.items()):
            fail(f"a world of 1 ({backend}): gaps {gaps} beyond twice the no-group repeat's")
        del one, again
        work1 = os.path.join(base, "world1")
        t0 = time.perf_counter()
        tr = count(train.main, [train_paths["cfg"], "--work_dir", work1, "--epochs", "1",
                                "--no_validate", "--seed", "0"])
        w1_s = time.perf_counter() - t0
        trained = {k: v.detach().cpu() for k, v in tr.bundle.model.state_dict().items()}
        w1_steps = tr.step
        del tr
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    fresh = build_detector(cfg, seed=7)
    _, meta = ckpt.load_checkpoint(work1, fresh.model)
    loaded = fresh.model.state_dict()
    if (set(loaded) != set(trained) or any(k.startswith("module.") for k in loaded)
            or not all(torch.equal(loaded[k].cpu(), v) for k, v in trained.items())):
        fail("the world of 1's checkpoint does not load with no group into the trained state")
    del fresh, ref_a
    print(f"data parallel, a world of 1 ({backend}, init_dist from RANK / WORLD_SIZE / "
          f"LOCAL_RANK / MASTER_ADDR / MASTER_PORT): phase 11's production step (B=2, bf16) "
          f"bit-equal to the step with no group: {world1_bits} (the no-group step repeats bit "
          f"for bit: {repeat_bits}; gaps {', '.join(f'{k} {v:.1e}' for k, v in gaps.items())}); "
          f"train --epochs 1 in that world: {w1_steps} steps in {w1_s:.1f} s, its checkpoint "
          f"(epoch {meta.get('epoch')}, no 'module.' prefix) loads with no group into the "
          "trained state bit for bit")

    # (b) a world of DP_WORLD on gloo -------------------------------------------
    ref, floors, floors_by = dp_reference(f32_backbone(train_paths["cfg"]), batch4, count)

    # phase 7's pool at one sweep a frame and the overfit twin's scene; a run
    # directory each for one process and for the world
    import test_torch_accuracy as acc

    pool_info = os.path.join(tmp, "nusc", "infos_train_10sweeps_withvelo.pkl")
    pool = load(pool_info)
    runs = {}
    for name in ("one", "world"):
        d = os.path.join(base, name)
        os.makedirs(d)
        info = os.path.join(d, "infos.pkl")
        dump(pool, info)
        dump({"0": []}, os.path.join(d, "buffer.json"))
        sel = dict(type="FeatureSelector", budget=POOL_BUDGET, infos_origin=info,
                   buffer_file=os.path.join(d, "buffer.json"),
                   pred_store_file=os.path.join(d, "pred.npz"), distance_type="l2",
                   streaming=False)
        path = os.path.join(d, "select.py")
        write_config(path, sel, extra=(
            "import copy\ndata = copy.deepcopy(data)\n"
            f"data['val'].update(nsweeps=1, root_path='', info_path={info!r})\n"))
        runs[name] = dict(dir=d, cfg=path, dets=os.path.join(d, "dets.pkl"),
                          dets_pool=os.path.join(d, "pool", "dets.pkl"),
                          twin=acc.write_twin_config(os.path.join(d, "twin.py"), twin["info"]))
    work_select = os.path.join(tmp, "work")  # phase 7's checkpoint
    t0 = time.perf_counter()
    count(active_select.main, [runs["one"]["cfg"], "--checkpoint", work_select,
                               "--seed", "3407"])
    with pinned_convs():
        count(dist_test.main, [runs["one"]["cfg"], "--checkpoint", work_select, "--out",
                               runs["one"]["dets_pool"], "--work_dir",
                               os.path.dirname(runs["one"]["dets_pool"])])
    count(dist_test.main, [runs["one"]["twin"], "--checkpoint", twin["work"], "--out",
                           runs["one"]["dets"], "--work_dir", runs["one"]["dir"]])
    one_s = time.perf_counter() - t0
    torch.cuda.empty_cache()

    bev_cfg = os.path.join(base, "bevfusion.py")
    write_bevfusion_cli_config(bev_cfg, loop, os.path.join(base, "bevfusion_work"))
    job = dict(rendezvous=os.path.join(base, "rendezvous"), batch=batch_path,
               cfg_train=train_paths["cfg"], cfg_select=runs["world"]["cfg"],
               work_select=work_select, cfg_twin=runs["world"]["twin"], work_twin=twin["work"],
               dets=runs["world"]["dets"], dets_pool=runs["world"]["dets_pool"], cfg_bev=bev_cfg,
               budget=loop["budget"], out=os.path.join(base, "rank"))
    t0 = time.perf_counter()
    ctx = mp.start_processes(dp_rank, args=(DP_WORLD, job), nprocs=DP_WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + 600
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                fail(f"the gloo world of {DP_WORLD} outlived 600 s")
    except mp.ProcessRaisedException as e:
        fail(f"a rank of the gloo world failed:\n{e}")
    except mp.ProcessExitedException as e:
        fail(f"a rank of the gloo world exited: {e}")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    world_s = time.perf_counter() - t0
    ranks = []
    for r in range(DP_WORLD):
        with open(f"{job['out']}-{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    for r in ranks:
        for k in ("launches_step", "launches_select", "launches_bev"):
            for name, n in r[k].items():
                launches[name] += n

    # the step
    want = {c.__name__: 0 for c in counters if c.__name__ in ranks[0]["launches_step"]}
    want.update(banded_conv=K1_PER_TRAIN_STEP, banded_dw=K3_PER_TRAIN_STEP)
    for i, r in enumerate(ranks):
        if r["launches_step"] != want:
            fail(f"rank {i}'s step launched {r['launches_step']}, expected {want}")
        gaps = {p: dp_gap(ref[p], r[p]) for p in ("grads", "stats", "update")}
        tols = {p: max(STEP_TOL, 2 * floors[p]) for p in gaps}
        if not max(tols.values()) < 0.5:  # an update left undone reads a gap of 1
            fail(f"phase 24's step gates {tols} (floors {floors}) are too loose to fail")
        log_gap = max(abs(r["logs"][k] - ref["logs"][k]) / max(abs(ref["logs"][k]), 1e-30)
                      for k in ("loss", "loc_loss", "cls_loss", "grad_norm"))
        if (not all(gaps[p] <= tols[p] for p in gaps) or not log_gap <= 1e-2
                or r["logs"]["num_pos"] != ref["logs"]["num_pos"]):
            fail(f"rank {i}'s step against the no-group step on the {2 * DP_WORLD} frames: gaps "
                 f"{gaps} (tol {tols}; floors {floors}), logs {log_gap:.2e} (tol 1e-2), num_pos "
                 f"{r['logs']['num_pos']} vs {ref['logs']['num_pos']}")
    same_ranks = all(torch.equal(ranks[0]["update"][k], r["update"][k])
                     for r in ranks[1:] for k in ranks[0]["update"])
    if not same_ranks:
        fail("the ranks' updates differ: the reduced gradients are not the same on every rank")
    step_ms = [float(np.median(r["step_ms"])) for r in ranks]
    red_wall = [float(np.median([x[0] for x in r["reduce_ms"]])) for r in ranks]
    red_dev = [float(np.median([x[1] for x in r["reduce_ms"]])) for r in ranks]
    print(f"data parallel, a world of {DP_WORLD} gloo processes on this one card (NCCL refuses "
          f"two ranks on one device), spawned and joined in {world_s:.1f} s: phase 11's step "
          f"with its backbone in f32 and 2 frames a rank against the no-group step on the "
          f"{2 * DP_WORLD} frames (floor: the largest gap of "
          + "; ".join(f"{k} {', '.join(f'{p} {v:.2e}' for p, v in g.items())}"
                      for k, g in floors_by.items()) + "): "
          + "; ".join(f"{p} gap {dp_gap(ref[p], ranks[0][p]):.2e} (floor {floors[p]:.2e})"
                      for p in ("grads", "stats", "update"))
          + f" (tol twice the floor, at least {STEP_TOL:g}); the ranks' updates bit-equal; "
          f"launches a rank {ranks[0]['launches_step']}; step a rank {step_ms} ms (median of "
          f"{DP_TIMED}), the gradient all-reduce ({ranks[0]['grad_bytes'] / 1e6:.1f} MB) "
          f"{red_wall} ms on the host clock, {red_dev} ms between device events; two ranks "
          "sharing one card and reducing through host memory say nothing of scaling")

    # selection and evaluation
    one, world = runs["one"], runs["world"]
    same_files = {n: open(os.path.join(one["dir"], n), "rb").read()
                  == open(os.path.join(world["dir"], n), "rb").read()
                  for n in ("buffer.json", f"infos_{POOL_BUDGET}.pkl")}
    if not all(same_files.values()):
        fail(f"active_select in a world of {DP_WORLD}: files differ from one process's: "
             f"{same_files}")
    a, b = np.load(os.path.join(one["dir"], "pred.npz")), np.load(os.path.join(world["dir"],
                                                                              "pred.npz"))
    scores_bits = all(np.array_equal(a[k], b[k]) for k in a)
    with open(one["dets"], "rb") as f:
        dets_one = pickle.load(f)
    with open(world["dets"], "rb") as f:
        dets_world = pickle.load(f)
    matched, n_a, n_b, box_gap, score_gap, _ = match_sets(dets_one, dets_world)
    if (list(dets_one) != list(dets_world) or matched != n_a or n_a != n_b
            or score_gap > 1e-4 or n_a < TWIN_MIN_DETS):
        fail(f"dist_test on the overfit twin in a world of {DP_WORLD}: {matched} of {n_a} "
             f"detections paired (world {n_b}; at least {TWIN_MIN_DETS}), score gap "
             f"{score_gap:.2e}")
    pool_dets = []
    for r in (one, world):
        with open(r["dets_pool"], "rb") as f:
            pool_dets.append(pickle.load(f))
    pool_bits = list(pool_dets[0]) == list(pool_dets[1]) and all(
        np.array_equal(v, pool_dets[1][t][k]) for t, d in pool_dets[0].items()
        for k, v in d.items())
    p_matched, p_a, p_b, p_box, p_score, _ = match_sets(*pool_dets)
    if (list(pool_dets[0]) != list(pool_dets[1]) or p_matched != p_a or p_a != p_b
            or p_score > 1e-4 or p_a < len(pool)):
        fail(f"dist_test on phase 7's pool in a world of {DP_WORLD}, cuDNN's choice pinned: "
             f"{p_matched} of {p_a} detections paired (world {p_b}; at least {len(pool)}), "
             f"score gap {p_score:.2e}")
    n_pool_batches = -(-len(pool) // (2 * DP_WORLD))
    want_sel = {c.__name__: 0 for c in counters if c.__name__ in ranks[0]["launches_select"]}
    # the pool's global batches twice (active_select, dist_test), and the
    # twin's one (a frame a rank)
    want_sel.update(banded_conv=K1_PER_PREDICT * (2 * n_pool_batches + 1),
                    iou_matrix=K2_PER_PREDICT * (2 * n_pool_batches + 1))
    for i, r in enumerate(ranks):
        if r["launches_select"] != want_sel:
            fail(f"rank {i}'s active_select + dist_test launched {r['launches_select']}, "
                 f"expected {want_sel}")
    print(f"  active_select (FeatureSelector, L2 k-center, budget {POOL_BUDGET}) on phase 7's "
          f"{len(pool)}-frame pool and checkpoint, one sweep a frame: buffer and subset "
          f"byte-equal to one process's {same_files}; pool scores bit-equal {scores_bits} "
          "(reported: cuDNN's autotuned choices may differ between processes); dist_test on "
          f"that pool at full width, 2 frames a rank as one process forwards them, cuDNN's "
          f"choice pinned in both: {p_matched} of {p_a} detections paired (world {p_b}; tol: "
          f"within 1e-3 of max(1, |box|), scores within 1e-4, at least one a frame; box gap "
          f"{p_box:.1e}, score gap {p_score:.1e}), bit-equal {pool_bits}; dist_test on "
          f"the overfit twin's scene, a frame a rank against both frames in one process: "
          f"{matched} of {n_a} detections paired (world {n_b}; tol: within 1e-3 of max(1, "
          f"|box|), scores within 1e-4, at least {TWIN_MIN_DETS}; box gap {box_gap:.1e}, score "
          f"gap {score_gap:.1e}); one process {one_s:.1f} s, a rank "
          f"{ranks[0]['select_s']:.1f} s; launches a rank {ranks[0]['launches_select']} (2 "
          f"frames of every global batch of {2 * DP_WORLD}, and the twin's frame)")

    # BEVFusion training
    per_step = dict(gather_gemm=K4_PER_BF_TRAIN_STEP, gather_dw=K4_DW_PER_BF_TRAIN_STEP,
                    gather_rows=K5_PER_BF_TRAIN_STEP,
                    linear_sum_assignment=LSA_PER_BF_TRAIN_STEP)
    for i, r in enumerate(ranks):
        n = r["bev_steps"]
        want_bev = {k: 0 for k in r["launches_bev"]}
        want_bev.update({k: v * n for k, v in per_step.items()})
        if (n < 1 or r["launches_bev"] != want_bev
                or not all(np.isfinite(v) for v in r["bev_logs"].values())):
            fail(f"rank {i}'s train_bevfusion: {n} steps, launched {r['launches_bev']} (expected "
                 f"{want_bev}), logs {r['bev_logs']}")
    print(f"  train_bevfusion --epochs 1 --budget {loop['budget']} in the world: "
          f"{ranks[0]['bev_steps']} steps of a global batch of "
          f"{2 * DP_WORLD} in {ranks[0]['bev_s']:.1f} s; launches a rank "
          f"{ranks[0]['launches_bev']} (phase 18's per step); logs {ranks[0]['bev_logs']}")
    print(f"phase 24 (data parallel): {time.perf_counter() - t_phase:.1f} s; launches {launches}")
    return dict(launches=launches, step_ms=step_ms, reduce_ms=red_dev)


if __name__ == "__main__":
    main()
