"""Gloo worlds for the data-parallel tests of the port, and the checks their
ranks run.

``start_world`` spawns W processes (``torch.multiprocessing``, spawn); each
takes two intra-op threads, joins a ``gloo`` group through a ``file://``
rendezvous in its own temporary directory (so that test workers running side
by side share no port), runs the named checks of this module and pickles
what each returns, or the traceback of a check that raised, into that
directory. ``join_world`` waits for the world within its timeout, stops every
process on a timeout, and returns each rank's results. The group's own
timeout is ``parallel.dist.GROUP_TIMEOUT``, so a rank left alone in a
collective fails instead of hanging.

Each check is ``check(rank, world, **kw)``; the same function run with no
group (rank 0 of a world of 1) gives the one-process reference. This module
imports no JAX, so the spawned processes start quickly.
"""
from __future__ import annotations

import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

THREADS = 2  # intra-op threads a rank: the lane runs several workers side by side


def _rank_main(rank: int, world: int, tmp: str, checks: list, group: bool,
               backend: str) -> None:
    torch.set_num_threads(THREADS)
    from dal3d_tpu_torch.parallel.dist import GROUP_TIMEOUT

    if backend == "nccl":
        torch.cuda.set_device(rank)
    if group:
        dist.init_process_group(backend, rank=rank, world_size=world, timeout=GROUP_TIMEOUT,
                                init_method=f"file://{os.path.join(tmp, 'rendezvous')}")
    results = {}
    try:
        for name, fn, kw in checks:
            try:
                results[name] = globals()[fn](rank, world, **kw)
            except Exception:
                results[name] = ("raised", traceback.format_exc())
    finally:
        if group:
            dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def start_world(world: int, tmp: str, checks: list, group: bool = True,
                backend: str = "gloo"):
    """Spawn a world of ``world`` ranks that runs ``checks``, a list of
    (name, function name in this module, keyword arguments), in order;
    ``group=False`` (with ``world=1``): one process with no group, the
    one-process reference. ``backend="nccl"`` puts rank r on card r. Returns
    the handle ``join_world`` takes."""
    os.makedirs(tmp, exist_ok=True)
    ctx = mp.start_processes(_rank_main, args=(world, tmp, checks, group, backend),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, world, tmp


def join_world(handle, timeout: float = 300.0) -> list:
    """Each rank's {check name: result}; raises when a process failed or the
    world outlived ``timeout`` seconds (then every process is stopped)."""
    ctx, world, tmp = handle
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"the gloo world of {world} outlived {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def result(results: dict, name: str):
    """A check's result; a check that raised fails here with its traceback."""
    r = results[name]
    if isinstance(r, tuple) and len(r) == 2 and r[0] == "raised":
        raise AssertionError(f"check {name} raised in its rank:\n{r[1]}")
    return r


# ---------------------------------------------------------------------------
# parallel/dist.py
# ---------------------------------------------------------------------------
# tests/test_dist.py's payloads: pickles of different sizes
PAYLOADS = [{"rank": 0, "payload": list(range(50))}, {"rank": 1}, {"rank": 2, "blob": "x" * 257}]


def dist_helpers(rank, world, tmp):
    from dal3d_tpu_torch.parallel import dist as pd

    calls = []

    @pd.master_only
    def write():
        calls.append(rank)
        return "wrote"

    wrote = write()
    pd.synchronize()
    path = os.path.join(tmp, "written.json")
    pd.write_once(lambda: open(path, "w").write('{"ranks": %d}' % world))
    x = torch.full((3,), float(rank + 1), requires_grad=True)
    y = pd.all_reduce_sum(x)
    (y * torch.arange(3.0)).sum().backward()
    return {"info": pd.get_dist_info(), "gathered": pd.all_gather_objects(PAYLOADS[rank]),
            "wrote": wrote, "calls": calls, "read": open(path).read(),
            "sum": y.detach().numpy(), "grad": x.grad.numpy(),
            "normaliser": float(pd.shared_normaliser(torch.tensor(float(rank)), 1.0)),
            "init_dist": pd.init_dist("gloo")}


class _Built(Exception):
    """Stops a CLI's ``main`` once its train set is built."""


def resampled_infos(rank, world, tool: str, cfg: str, work: str):
    """``tool``'s ``main`` (``train`` with no ``--seed``, or
    ``train_bevfusion``) with --cpu, from a state of numpy's global
    generator of the rank's own (seed 1000 + rank, as processes with no
    seed start from states of their own), stopped when it builds its
    optimizer: the tokens of the train set it resampled, in order, and the
    first draw of numpy's global generator after the build (the pipeline's
    first draw)."""
    from dal3d_tpu_torch.data import dataset_factory
    from dal3d_tpu_torch.models import builder
    from dal3d_tpu_torch.solver import optim
    from dal3d_tpu_torch.tools import train, train_bevfusion

    np.random.seed(1000 + rank)
    seen = {}
    build = dataset_factory.build_dataset

    def record(*a, **k):
        ds = build(*a, **k)
        seen["tokens"] = [i["token"] for i in ds.infos]
        return ds

    def stop(*a, **k):
        seen["next_draw"] = int(np.random.randint(2 ** 31))
        raise _Built

    where, name = (optim, "build_optimizer") if tool == "train" else (builder,
                                                                      "bevfusion_optimizer")
    saved = getattr(where, name)
    dataset_factory.build_dataset = record
    setattr(where, name, stop)
    try:
        {"train": train, "train_bevfusion": train_bevfusion}[tool].main(
            [cfg, "--cpu", "--epochs", "1", "--work_dir", work])
    except _Built:
        pass
    finally:
        dataset_factory.build_dataset = build
        setattr(where, name, saved)
    return seen


def gathered_rows(rank, world):
    """``data_parallel_predict`` over a step that returns rows of several
    dtypes, and ``shard_batch`` of a global batch."""
    from dal3d_tpu_torch.parallel.mesh import data_parallel_predict, shard_batch

    batch = global_rows(world)
    mine = shard_batch(batch, rank, world)

    def predict(b):
        x = torch.as_tensor(b["x"])
        return {"f32": x * 2.0, "i32": x.to(torch.int32), "i64": x.long() + 1,
                "bool": x > 3, "bf16": x.to(torch.bfloat16), "wide": x[:, :, None].repeat(1, 1, 3)}

    out = data_parallel_predict(predict)(mine)
    return {"mine": mine, "out": {k: v.float().numpy() for k, v in out.items()}}


def global_rows(world: int, b: int = 2) -> dict:
    """A global batch of world x b rows: an array, per-task lists and per-frame
    metadata."""
    n = world * b
    x = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
    return {"x": x, "gt": [x[:, :2].copy(), x[:, 2:].copy()],
            "metadata": [{"token": f"t{i}"} for i in range(n)]}


# ---------------------------------------------------------------------------
# the synced norms
# ---------------------------------------------------------------------------
NORM_B, NORM_C = 4, 8


def norm_inputs(kind: str):
    """(layer kwargs, input, mask or None, the loss's weights) of a norm test,
    the same in every process."""
    rng = np.random.RandomState({"masked": 1, "2d": 2, "last": 3}[kind])
    shape = {"masked": (NORM_B, 40, NORM_C), "2d": (NORM_B, NORM_C, 6, 5),
             "last": (NORM_B, 10, NORM_C)}[kind]
    x = (rng.randn(*shape) * 2 + 1).astype(np.float32)
    mask = rng.rand(NORM_B, 40) < 0.7 if kind == "masked" else None
    return x, mask, rng.randn(*shape).astype(np.float32), rng


def norm_step(rank, world, kind: str):
    """One train-mode forward and backward of a norm on the rank's rows:
    output, running statistics, input gradient, weight and bias gradients
    (the rank's share; summed over the ranks they are the global batch's)."""
    from dal3d_tpu_torch.models.layers import BatchNorm2d, BatchNormLast, MaskedBatchNorm

    x, mask, w, rng = norm_inputs(kind)
    layer = {"masked": MaskedBatchNorm, "2d": BatchNorm2d, "last": BatchNormLast}[kind](NORM_C)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(1 + 0.2 * rng.randn(NORM_C).astype(np.float32)))
        layer.bias.copy_(torch.from_numpy(0.1 * rng.randn(NORM_C).astype(np.float32)))
    layer.train()
    b = NORM_B // world
    rows = slice(rank * b, (rank + 1) * b)
    xr = torch.from_numpy(x[rows]).requires_grad_(True)
    y = layer(xr, torch.from_numpy(mask[rows])) if mask is not None else layer(xr)
    (y * torch.from_numpy(w[rows])).sum().backward()
    return {"y": y.detach().numpy(), "x_grad": xr.grad.numpy(),
            "w_grad": layer.weight.grad.numpy(), "b_grad": layer.bias.grad.numpy(),
            "running_mean": layer.running_mean.numpy().copy(),
            "running_var": layer.running_var.numpy().copy()}


# ---------------------------------------------------------------------------
# the CBGS train step
# ---------------------------------------------------------------------------
STEP_ONE_CYCLE = dict(lr_max=0.002, moms=(0.95, 0.85), div_factor=10.0, pct_start=0.4,
                      total_steps=100)


def cbgs_step(rank, world, impl: str, device: str = "cpu", frames: int = 2,
              nudge: float = 0.0):
    """One train step of the small CBGS detector (``impl`` "banded" or
    "gather") on the rank's rows of a batch of ``frames`` frames, on
    ``device`` (for "cuda", the rank's current card), each voxel feature
    scaled by 1 + ``nudge`` x a seeded normal draw: the logs, the averaged
    gradients and, after AdamW, the parameters and running statistics (on
    the host)."""
    from dal3d_tpu_torch.models.builder import build_detector
    from dal3d_tpu_torch.parallel.mesh import shard_batch
    from dal3d_tpu_torch.runtime.steps import make_train_step
    from dal3d_tpu_torch.solver.optim import OneCycleSchedule, build_optimizer
    from torch_port_utils import small_cfg, small_gather_cfg, small_gt, small_voxels

    cfg = small_cfg("float32") if impl == "banded" else small_gather_cfg()
    bundle = build_detector(cfg, device=device, seed=0)
    vf, vc, vv = small_voxels(0, B=frames)
    vf = (vf * (1 + nudge * np.random.RandomState(22).randn(*vf.shape))).astype(np.float32)
    gt_boxes, gt_classes = small_gt(cfg, 0, B=frames)
    batch = {"voxel_features": vf, "voxel_coords": vc, "voxel_valid": vv,
             "gt_boxes": gt_boxes, "gt_classes": gt_classes}
    opt = build_optimizer(OneCycleSchedule(**STEP_ONE_CYCLE)).init(
        bundle.model.named_parameters())
    logs = make_train_step(bundle, opt)(shard_batch(batch, rank, world))
    sd = bundle.model.state_dict()
    return {"logs": {k: float(v) for k, v in logs.items()},
            "grads": {n: p.grad.cpu().numpy().copy() for n, p in opt.params.items()},
            "state": {k: v.cpu().numpy().copy() for k, v in sd.items()}}


# a gradient whose scale is below this share of the largest is rounding noise:
# the conv biases in front of a batch norm (5e-9 to 1.4e-7 of it on the small
# CBGS step on the CPU; the next smallest, the box heads' biases, 2e-4)
NOISE = 1e-6
# the step's gradients against one process: moving the voxel features by one
# ulp moves the box heads' gradients of the one-process step on the CPU by up
# to 1.6e-4 of their scale (the train-mode norms' E[x^2] - E[x]^2 cancels),
# so the two, which sum the batch in other orders, are held within this
GRAD_TOL = 1e-3


def _scale_gap(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def check_step(got: dict, ref: dict) -> None:
    """A rank's ``cbgs_step`` against the one-process step on the global
    batch: loss and its parts within 1e-5 relative, the grad norm within
    GRAD_TOL relative (the norm of gradients held within GRAD_TOL),
    ``num_pos`` equal, every gradient within GRAD_TOL of its scale but the
    noise ones (held below NOISE of the largest), the running statistics
    within 1e-5 of scale, the parameters within 1e-6 wherever the gradient
    is above 1e-4 of its tensor's scale and within 2 lr + 1e-6 elsewhere
    (Adam's first update is lr x sign(g): a gradient at rounding level may
    flip it). Fails with every gap beyond its tolerance."""
    lr = STEP_ONE_CYCLE["lr_max"] / STEP_ONE_CYCLE["div_factor"]  # the first step's
    bad = []
    for k in ("loss", "loc_loss", "cls_loss", "grad_norm"):
        gap = abs(got["logs"][k] - ref["logs"][k]) / abs(ref["logs"][k])
        if not gap <= (GRAD_TOL if k == "grad_norm" else 1e-5):
            bad.append(f"{k} {got['logs'][k]} vs {ref['logs'][k]} (rel {gap:.2e})")
    if not got["logs"]["num_pos"] == ref["logs"]["num_pos"] > 0:
        bad.append(f"num_pos {got['logs']['num_pos']} vs {ref['logs']['num_pos']}")
    top = max(float(np.abs(g).max()) for g in ref["grads"].values())
    noise = {n for n, g in ref["grads"].items() if float(np.abs(g).max()) < NOISE * top}
    if not (noise and all(n.endswith("bias") for n in noise)):
        bad.append(f"noise-level gradients {sorted(noise)}")
    for n, g in ref["grads"].items():
        if n in noise:
            if not float(np.abs(got["grads"][n]).max()) < NOISE * top:
                bad.append(f"grad {n} above the noise level")
        elif not _scale_gap(got["grads"][n], g) <= GRAD_TOL:
            bad.append(f"grad {n} {_scale_gap(got['grads'][n], g):.2e} of scale")
    for k, v in ref["state"].items():
        if "running" in k:
            if not _scale_gap(got["state"][k], v) <= 1e-5:
                bad.append(f"{k} {_scale_gap(got['state'][k], v):.2e} of scale")
            continue
        gap = np.abs(got["state"][k] - v)
        g = np.abs(ref["grads"][k])
        clear = g > 1e-4 * max(float(g.max()), 1e-30)
        if k not in noise and not float(gap[clear].max(initial=0.0)) <= 1e-6:
            bad.append(f"{k} moved {float(gap[clear].max()):.2e} apart")
        if not float(gap.max()) <= 2 * lr + 1e-6:
            bad.append(f"{k} {float(gap.max()):.2e} apart, beyond 2 lr")
    assert not bad, "; ".join(bad)


def _whole_gap(ref: dict, got: dict) -> float:
    num = sum(float(np.square(got[k].astype(np.float64) - v).sum()) for k, v in ref.items())
    return (num / sum(float(np.square(v.astype(np.float64)).sum()) for v in ref.values())) ** 0.5


def check_step_floor(got: dict, ref: dict, nudged: dict) -> str:
    """A rank's ``cbgs_step`` against the one-process step where rounding
    alone moves the gradient by percents (on the card, and with 4 frames on
    the CPU: units of the 4 x 4 neck maps within rounding of a ReLU's kink,
    ``chip_smoke.py`` phase 10): the gradient as a whole and the running
    statistics within twice the gap that the one-process step on features
    moved by about one ulp (``nudged``) opens, and at least 1e-3; loss and
    its parts within 1e-4 relative; ``num_pos`` equal. Returns the gaps;
    fails beyond them."""
    running = [k for k in ref["state"] if "running" in k]
    gaps = {"grads": (_whole_gap(ref["grads"], got["grads"]),
                      _whole_gap(ref["grads"], nudged["grads"])),
            "stats": (_whole_gap({k: ref["state"][k] for k in running}, got["state"]),
                      _whole_gap({k: ref["state"][k] for k in running}, nudged["state"]))}
    bad = [f"{k} gap {g:.2e} beyond twice its floor {f:.2e}" for k, (g, f) in gaps.items()
           if not g <= max(1e-3, 2 * f)]
    for k in ("loss", "loc_loss", "cls_loss"):
        gap = abs(got["logs"][k] - ref["logs"][k]) / abs(ref["logs"][k])
        if not gap <= 1e-4:
            bad.append(f"{k} {got['logs'][k]} vs {ref['logs'][k]} (rel {gap:.2e})")
    if not got["logs"]["num_pos"] == ref["logs"]["num_pos"] > 0:
        bad.append(f"num_pos {got['logs']['num_pos']} vs {ref['logs']['num_pos']}")
    assert not bad, "; ".join(bad)
    return ", ".join(f"{k} gap {g:.2e} (floor {f:.2e})" for k, (g, f) in gaps.items())


def same_step(a: dict, b: dict) -> bool:
    """Two ``cbgs_step`` results equal bit for bit."""
    return a["logs"] == b["logs"] and all(
        np.array_equal(a[part][k], b[part][k]) for part in ("grads", "state") for k in a[part])


# ---------------------------------------------------------------------------
# the loss normalisers: TransFusion and the estimator
# ---------------------------------------------------------------------------
TF_CFG = dict(out_size_factor=8, voxel_size=(0.2, 0.2), pc_range=(-12.8, -12.8))
TF_B, TF_P, TF_G, TF_NC, TF_HW = 2, 24, 10, 10, 16
TF_KEYS = ("center", "height", "dim", "rot", "vel", "cls_logits", "heatmap")


def transfusion_case():
    """Predictions near a padded GT set, 2 frames (frame 1 matches more
    boxes than frame 0, so the two ranks' counts differ)."""
    rng = np.random.RandomState(5)
    gt = np.zeros((TF_B, TF_G, 9), np.float32)
    gt[..., 3:6] = 1.0
    gcls = np.zeros((TF_B, TF_G), np.int32)
    for b in range(TF_B):
        n = 4 + 4 * b
        gt[b, :n, :2] = rng.uniform(-11, 11, (n, 2))
        gt[b, :n, 2] = rng.uniform(-1.5, 0.5, n)
        gt[b, :n, 3:6] = rng.uniform(0.5, 4.5, (n, 3))
        gt[b, :n, 8] = rng.uniform(-3, 3, n)
        gcls[b, :n] = rng.randint(1, TF_NC + 1, n)
    f, vs, pc = TF_CFG["out_size_factor"], TF_CFG["voxel_size"][0], TF_CFG["pc_range"][0]
    center = rng.uniform(0, TF_HW, (TF_B, TF_P, 2))
    center[:, :8] = (gt[:, :8, :2] - pc) / (f * vs) + rng.randn(TF_B, 8, 2) * 0.2
    dim = rng.randn(TF_B, TF_P, 3) * 0.5
    dim[:, :8] = np.log(gt[:, :8, 3:6]) + rng.randn(TF_B, 8, 3) * 0.1
    yaw = rng.uniform(-3, 3, (TF_B, TF_P))
    preds = {"center": center, "height": rng.randn(TF_B, TF_P, 1), "dim": dim,
             "rot": np.stack([np.cos(yaw), np.sin(yaw)], -1) * 0.9,
             "vel": rng.randn(TF_B, TF_P, 2), "cls_logits": rng.randn(TF_B, TF_P, TF_NC) * 2,
             "heatmap": rng.randn(TF_B, TF_HW, TF_HW, TF_NC) * 2}
    preds = {k: np.asarray(v, np.float32) for k, v in preds.items()}
    preds["query_labels"] = rng.randint(0, TF_NC, (TF_B, TF_P)).astype(np.int32)
    preds["query_score"] = rng.rand(TF_B, TF_P).astype(np.float32)
    return preds, gt, gcls


def transfusion_share(rank, world):
    """``transfusion_loss`` on the rank's rows: its logs and the gradient of
    its loss with respect to its rows' predictions."""
    from dal3d_tpu_torch.models.bevfusion.transfusion import TransFusionTestCfg, transfusion_loss

    preds, gt, gcls = transfusion_case()
    b = TF_B // world
    rows = slice(rank * b, (rank + 1) * b)
    leaves = {k: torch.from_numpy(preds[k][rows]).requires_grad_(True) for k in TF_KEYS}
    fixed = {k: torch.from_numpy(v[rows]) for k, v in preds.items() if k not in TF_KEYS}
    logs = transfusion_loss({**leaves, **fixed}, torch.from_numpy(gt[rows]),
                            torch.from_numpy(gcls[rows]), TransFusionTestCfg(**TF_CFG))
    logs["loss"].backward()
    return {"logs": {k: float(logs[k].detach()) for k in ("loss", "cls_loss", "reg_loss", "heatmap_loss",
                                                  "num_matched")},
            "grads": {k: v.grad.numpy() for k, v in leaves.items()}}


EST_B, EST_K, EST_P = 4, 6, 300


def estimator_case():
    """Points, boxes around point clusters, validity and targets of 4 frames
    with different counts of valid boxes."""
    rng = np.random.RandomState(6)
    points = np.zeros((EST_B, EST_P, 5), np.float32)
    boxes = np.zeros((EST_B, EST_K, 9), np.float32)
    for b in range(EST_B):
        centres = rng.uniform(-8, 8, (EST_K, 2))
        boxes[b, :, :2] = centres
        boxes[b, :, 2] = -0.5
        boxes[b, :, 3:6] = rng.uniform(1.0, 4.0, (EST_K, 3))
        boxes[b, :, 8] = rng.uniform(-3, 3, EST_K)
        owner = rng.randint(EST_K, size=EST_P)
        points[b, :, :2] = centres[owner] + rng.randn(EST_P, 2) * 0.5
        points[b, :, 2] = rng.uniform(-1.5, 0.5, EST_P)
        points[b, :, 3] = rng.rand(EST_P)
    valid = rng.rand(EST_B, EST_K) < np.array([0.3, 0.6, 0.9, 0.5])[:, None]
    valid[:, 0] = True
    return (points, rng.rand(EST_B, EST_P) < 0.9, boxes, valid,
            rng.rand(EST_B, EST_K).astype(np.float32))


def estimator_share(rank, world):
    """``estimator_loss`` on the rank's rows with seeded weights: the loss
    and the gradient of every estimator weight (the rank's share)."""
    from dal3d_tpu_torch.models.detectors.estimator import Estimator, init_estimator_
    from dal3d_tpu_torch.runtime.active_trainer import estimator_loss

    est = init_estimator_(Estimator(max_pts=16, hidden=(16, 32)),
                          torch.Generator().manual_seed(3))
    b = EST_B // world
    rows = slice(rank * b, (rank + 1) * b)
    points, pv, boxes, valid, target = (torch.from_numpy(a[rows]) for a in estimator_case())
    loss = estimator_loss(est, points, pv, boxes, valid, target)
    loss.backward()
    return {"loss": float(loss.detach()), "grads": {n: p.grad.numpy().copy()
                                           for n, p in est.named_parameters()}}


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------
def run_clis(rank, world, cfg: str, work: str, out: str, seed: int):
    """``active_select`` and ``dist_test`` through their ``main`` on the CPU:
    what ``dist_test`` returns."""
    from dal3d_tpu_torch.tools import active_select, dist_test

    active_select.main([cfg, "--checkpoint", work, "--cpu", "--seed", str(seed)])
    return dist_test.main([cfg, "--checkpoint", work, "--out", out, "--cpu",
                           "--work_dir", os.path.dirname(out)])


def refused(rank, world, argv: list, tool: str = "train"):
    """The message a CLI refuses ``argv`` with, or None when it runs."""
    from dal3d_tpu_torch.tools import train, train_bevfusion

    try:
        {"train": train, "train_bevfusion": train_bevfusion}[tool].main(argv)
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return None
