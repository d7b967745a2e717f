"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX runs
on the CPU as the reference. Tests of the CUDA kernels take the ``cuda``
fixture, which skips when the box has no GPU (decided inside the test, never
at import time)."""
import numpy as np
import pytest
import torch

# The lane runs several pytest workers side by side, and every worker imports
# this module when it collects the files. PyTorch's default of one intra-op
# thread a core makes the workers' OpenMP threads spin against each other:
# six copies of tests/test_torch_iou_cull.py side by side on 8 cores took
# 482 s with 8 threads each, 17 s with 2.
torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU for the port's CUDA kernels")
    return torch.device("cuda")


def t(x, dtype=None):
    """numpy / jax array -> CPU torch tensor (copied, writable)."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def mk_rulebook(rng, B, Q, M, Mb, spread, miss_p=0.3):
    """Banded-ish random rulebook (idx, hit) as numpy, as tests/test_banded.py."""
    m = np.arange(M)
    center = (m * Mb) // M
    idx = np.clip(center[None, :] + rng.randint(-spread, spread + 1, (Q, M)), 0, Mb - 1)
    idx = np.tile(idx[None], (B, 1, 1)).astype(np.int32)
    hit = rng.rand(B, Q, M) >= miss_p
    return idx, hit


def small_cfg(dtype="float32", pre=64, post=16):
    """A CBGS config cut to a 12.8 m x 12.8 m grid at 0.2 m (sparse shape
    (41, 64, 64)), small brick capacities, and NMS sizes that fit its 8x8
    anchor map; widths and layer counts are the production ones. Plain nested
    dicts, loaded from configs/_cbgs_base.py."""
    import copy
    import os

    from dal3d_tpu_torch.utils.config import Config

    base = Config.fromfile(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "_cbgs_base.py"))
    cfg = copy.deepcopy({k: base[k] for k in ("tasks", "box_coder", "model", "test_cfg",
                                              "voxel_generator", "target_assigner")})
    cfg["voxel_generator"].update(range=[-6.4, -6.4, -5.0, 6.4, 6.4, 3.0],
                                  voxel_size=[0.2, 0.2, 0.2])
    for g in cfg["target_assigner"]["anchor_generators"]:
        z = g["anchor_ranges"][2]
        g["anchor_ranges"] = [-6.4, -6.4, z, 6.4, 6.4, z]
    cfg["model"]["backbone"].update(
        dtype=dtype, brick_widths=(8, 8, 8, 4, 4), banded_caps=(1536, 1536, 768, 384, 384),
        band_widths=(256, 256, 128, 128, 128), down_bands=(512, 256, 128, 128),
        band_fb_cap=2048)
    cfg["test_cfg"]["nms"].update(nms_pre_max_size=pre, nms_post_max_size=post,
                                  use_approx_topk=False)
    cfg["test_cfg"]["post_center_limit_range"] = [-10.0, -10.0, -10.0, 10.0, 10.0, 10.0]
    return cfg


def small_gather_cfg(caps=(1920, 1536, 384, 128)):
    """``small_cfg`` with no backbone engine named, so the gather engine (the
    default, as in JAX) with voxel caps ``caps`` after each downsample."""
    cfg = small_cfg("float32")
    bb = cfg["model"]["backbone"]
    for k in ("impl", "dtype", "brick_widths", "banded_caps", "band_widths", "down_bands",
              "band_fb_cap"):
        bb.pop(k, None)
    bb["voxel_caps"] = tuple(caps)
    return cfg


def small_voxels(seed, B=2, N=1500, shape=(41, 64, 64)):
    """Host voxels of clustered (lidar-like) scenes: features [B, N, 5] f32,
    coords [B, N, 3] int32 (z, y, x), valid [B, N]; unique coords."""
    rng = np.random.RandomState(seed)
    D, H, W = shape
    vf = np.zeros((B, N, 5), np.float32)
    vc = np.zeros((B, N, 3), np.int32)
    vv = np.zeros((B, N), bool)
    for b in range(B):
        pts = []
        while len(pts) < N - N // 8:
            z, y, x0 = rng.randint(2, D - 2), rng.randint(H), rng.randint(W)
            for dx in range(rng.randint(1, 10)):
                if x0 + dx < W:
                    pts.append((z, y, x0 + dx))
        pts = list(dict.fromkeys(pts))
        n = len(pts)
        vc[b, :n] = np.array(pts)
        vf[b, :n] = rng.randn(n, 5)
        vv[b, :n] = True
    return vf, vc, vv


def small_gt(cfg, seed, B=2, G=8, per_task=1):
    """Padded per-task GT boxes for ``small_cfg``'s 12.8 m grid: ``per_task``
    boxes per sample and task, each near its class's anchor size and height,
    with a velocity and a yaw. Returns (gt_boxes, gt_classes): lists per task
    of [B, G, 9] f32 and [B, G] int32 (task-local 1-based, 0 = pad)."""
    rng = np.random.RandomState(seed)
    gens = cfg["target_assigner"]["anchor_generators"]
    gt_boxes, gt_classes, flag = [], [], 0
    for task in cfg["tasks"]:
        nc = task["num_class"]
        tb = np.zeros((B, G, 9), np.float32)
        tb[..., 3:6] = 1.0
        tc = np.zeros((B, G), np.int32)
        for b in range(B):
            for k in range(per_task):
                c = rng.randint(nc)
                g = gens[flag + c]
                size = np.asarray(g["sizes"], np.float32) * rng.uniform(0.9, 1.1, 3)
                tb[b, k] = [rng.uniform(-5, 5), rng.uniform(-5, 5), g["anchor_ranges"][2], *size,
                            rng.uniform(-1, 1), rng.uniform(-1, 1), rng.uniform(-3.1, 3.1)]
                tc[b, k] = c + 1
        gt_boxes.append(tb)
        gt_classes.append(tc)
        flag += nc
    return gt_boxes, gt_classes
