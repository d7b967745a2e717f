"""The 13 selectors of the PyTorch port (CPU) against the JAX package's: the
same synthetic infos, logs, scoring cache and ``random.seed`` go through
``dal3d_tpu.selectors`` and ``dal3d_tpu_torch.selectors``; the buffer JSON and
the subset infos ``.pkl`` must be equal byte for byte. Plus the properties
``tests/test_selectors.py`` holds the JAX selectors to: streaming == matrix,
round accumulation, ``exclude_buffer``, pipeline-depth invariance."""
import os
import pickle
import random
import shutil

import numpy as np
import pytest
import torch

from dal3d_tpu import selectors as jsel
from dal3d_tpu.data.datasets.synthetic import make_synthetic_nuscenes
from dal3d_tpu_torch import selectors as tsel
from dal3d_tpu_torch.selectors.base_selector import BaseSelector
from dal3d_tpu_torch.utils.fileio import dump, load

CLASSES = ["car", "truck", "construction_vehicle", "bus", "trailer",
           "barrier", "motorcycle", "bicycle", "pedestrian", "traffic_cone"]


@pytest.fixture()
def env(tmp_path):
    """Synthetic infos + logs + scoring cache + PPAL / CALD inputs, and one
    working directory per package holding its own buffer and infos copy."""
    src = make_synthetic_nuscenes(str(tmp_path / "nusc"), n_frames=30, n_logs=3,
                                  points_per_frame=100, seed=0)
    infos = load(src)
    logfiles = sorted({i["cam_front_path"].split("/")[-1].split("__")[0] for i in infos})
    shared = dict(logs_file=str(tmp_path / "log.json"), npz=str(tmp_path / "pred.npz"),
                  diff_file=str(tmp_path / "diff.json"),
                  sorted_idx_file=str(tmp_path / "cald_sorted.json"),
                  jsdiv_file=str(tmp_path / "jsdiv.pkl"), n=len(infos), infos=infos)
    dump([{"logfile": lf, "location": "singapore-onenorth"} for lf in logfiles],
         shared["logs_file"])
    rng = np.random.RandomState(0)
    n = len(infos)
    np.savez(shared["npz"],
             embedding=np.abs(rng.randn(n, 16)).astype(np.float32),
             score_entropy=rng.uniform(0.1, 0.6, n).astype(np.float32),
             scores=rng.uniform(0.1, 0.9, (n, 24)).astype(np.float32),
             label_preds=rng.randint(0, 10, (n, 24)),
             det_valid=np.ones((n, 24), bool))
    dump({c: 1.0 + 0.1 * i for i, c in enumerate(CLASSES)}, shared["diff_file"])
    dump(rng.permutation(n).tolist(), shared["sorted_idx_file"])
    dump({i: float(rng.uniform()) for i in range(n)}, shared["jsdiv_file"])
    for side in ("jax", "torch"):
        d = tmp_path / side
        d.mkdir()
        shutil.copy(src, d / "infos.pkl")
        dump({"0": []}, str(d / "buffer.json"))
        shared[side] = str(d)
    return shared


def _selector_cfg(name, env, side):
    """Config of one selector; per-side files live in the side's directory."""
    d = env[side]
    spatial = dict(k=4, logs_file=env["logs_file"],
                   distance_store_file=os.path.join(d, f"dij_{name}.npy"))
    model = dict(pred_store_file=env["npz"])
    return {
        "RandomSelector": dict(type="RandomSelector"),
        "SpatialSelector": dict(type="SpatialSelector", **spatial),
        "EuSpatialSelector": dict(type="EuSpatialSelector", logs_file=env["logs_file"]),
        "TemporalSelector": dict(type="TemporalSelector"),
        "SpatialTemporalSelector": dict(type="SpatialTemporalSelector", **spatial,
                                        normalize="exp", lambda_t=1, aggregate="sum"),
        "SpatialTemporalSelector-linear-max": dict(type="SpatialTemporalSelector", **spatial,
                                                   normalize="linear", aggregate="max"),
        "FeatureSelector": dict(type="FeatureSelector", **model),
        "FeatureSelector-l2": dict(type="FeatureSelector", distance_type="l2", **model),
        "EntropySelector": dict(type="EntropySelector", **model),
        "BadgeSelector": dict(type="BadgeSelector", **model),
        "UWESelector": dict(type="UWESelector", **model),
        "PPALSelector": dict(type="PPALSelector", diff_file=env["diff_file"], delta=1.5, **model),
        "CaldSelector": dict(type="CaldSelector", sorted_idx_file=env["sorted_idx_file"],
                             jsdiv_file=env["jsdiv_file"]),
        "SpatialFeatureSelector": dict(type="SpatialFeatureSelector", **spatial, **model),
        "SpatialTemporalFeatureSelector": dict(type="SpatialTemporalFeatureSelector",
                                               **spatial, **model),
    }[name]


def _force_random(cfg):
    """What ``--force_random`` of the selection CLI makes of a config."""
    return {"type": "RandomSelector",
            **{k: cfg[k] for k in ("budget", "buffer_file", "dump_file_name", "infos_origin",
                                   "cost_b", "cost_f") if k in cfg}}


def _run(side, env, name, budget, seed=7, force_random=False, **extra):
    d = env[side]
    cfg = dict(_selector_cfg(name, env, side), budget=budget,
               buffer_file=os.path.join(d, "buffer.json"),
               infos_origin=os.path.join(d, "infos.pkl"), **extra)
    if force_random:
        cfg = _force_random(cfg)
    random.seed(seed)
    np.random.seed(seed)
    if side == "jax":
        sel = jsel.build_selector(cfg)
    else:
        sel = tsel.build_selector(cfg, default_args=dict(device="cpu"))
    sel.select_samples()
    sel.dump_file()
    key = sel.current_budget
    buffer_bytes = open(cfg["buffer_file"], "rb").read()
    subset_bytes = open(os.path.join(d, f"infos_{key}.pkl"), "rb").read()
    return load(cfg["buffer_file"])[key], buffer_bytes, subset_bytes


ALL = ["RandomSelector", "SpatialSelector", "EuSpatialSelector", "TemporalSelector",
       "SpatialTemporalSelector", "SpatialTemporalSelector-linear-max", "FeatureSelector",
       "FeatureSelector-l2", "EntropySelector", "BadgeSelector", "UWESelector", "PPALSelector",
       "CaldSelector", "SpatialFeatureSelector", "SpatialTemporalFeatureSelector",
       "force_random"]


@pytest.mark.parametrize("name", ALL)
def test_selector_writes_what_jax_writes(env, name):
    """Two rounds (the second starts from the first's buffer, so the prior-
    selection init runs too): buffer JSON and subset pkl equal byte for byte."""
    force = name == "force_random"
    sel_name = "FeatureSelector" if force else name
    for budget in (6, 5):
        a, a_buf, a_sub = _run("jax", env, sel_name, budget, force_random=force)
        b, b_buf, b_sub = _run("torch", env, sel_name, budget, force_random=force)
        assert b == a and len(b) == len(set(b)) > 0
        assert b_buf == a_buf
        assert b_sub == a_sub
        assert len(pickle.loads(b_sub)) == len(b)
    total = sum(0.12 + 0.04 * len(env["infos"][i]["gt_names"]) for i in b)
    assert total <= 11 + 1e-6


def test_all_thirteen_selectors_are_registered():
    names = set(tsel.SELECTORS.module_dict) - {"BaseSelector"}
    assert names == set(jsel.SELECTORS.module_dict) - {"BaseSelector"}
    assert len(names) == 13


@pytest.mark.parametrize("name", ["FeatureSelector", "FeatureSelector-l2", "PPALSelector"])
def test_streaming_matches_matrix(env, name):
    """streaming=True (kcenter_features, no N x N map) picks exactly what the
    materialized map picks, with a prior selection and PPAL's restricted pool;
    both equal JAX's."""
    picks = {}
    for side in ("jax", "torch"):
        for streaming in (False, True):
            dump({"0": [0, 5]}, os.path.join(env[side], "buffer.json"))
            picks[side, streaming], _, _ = _run(side, env, name, 6, streaming=streaming)
    assert picks["torch", True] == picks["torch", False] == picks["jax", False]
    assert picks["jax", True] == picks["torch", True] and len(picks["torch", True]) > 2


def test_round_accumulation(env):
    r1, _, _ = _run("torch", env, "TemporalSelector", 4)
    r2, _, _ = _run("torch", env, "TemporalSelector", 4)
    assert "8" in load(os.path.join(env["torch"], "buffer.json"))
    assert set(r1) <= set(r2) and len(r2) > len(r1)


def test_exclude_buffer_blocks_seed_frames(env):
    seed_file = os.path.join(env["torch"], "seed.json")
    seed_ids = list(range(10))
    dump({"partial_01": seed_ids}, seed_file)
    chosen, _, _ = _run("torch", env, "SpatialTemporalSelector", 3, exclude_buffer=seed_file)
    ref, _, _ = _run("jax", env, "SpatialTemporalSelector", 3, exclude_buffer=seed_file)
    assert chosen == ref and not set(chosen) & set(seed_ids)


def test_rng_argument_replaces_the_module_random(env):
    """An explicit ``random.Random`` gives the draw of the same seed of the
    module generator, and leaves the module generator alone."""
    a, _, _ = _run("torch", env, "RandomSelector", 6, seed=3)
    dump({"0": []}, os.path.join(env["torch"], "buffer.json"))
    random.seed(99)
    state = random.getstate()
    cfg = dict(type="RandomSelector", budget=6, device="cpu", rng=random.Random(3),
               buffer_file=os.path.join(env["torch"], "buffer.json"),
               infos_origin=os.path.join(env["torch"], "infos.pkl"))
    sel = tsel.build_selector(cfg)
    sel.select_samples()
    assert sel.get_selected_samples()["6"] == a
    assert random.getstate() == state


@pytest.mark.parametrize("as_tensor", [False, True])
def test_run_pool_scoring_pipeline_depth_invariant(tmp_path, as_tensor):
    """Per-frame results stay in loader order at any pipeline depth, with a
    padded last batch cut to the pool size; numpy and tensor outputs alike."""
    n, B, K = 9, 2, 4

    class _Loader:
        def __iter__(self):
            for i in range(0, n, B):
                yield {"idx": np.minimum(np.arange(i, i + B), n - 1)}

    def detector(batch):
        i = batch["idx"]
        out = {"embedding": np.tile(i[:, None].astype(np.float32), (1, 3)),
               "score_entropy": i.astype(np.float32),
               "scores": np.tile(i[:, None].astype(np.float32), (1, K)),
               "label_preds": np.tile(i[:, None], (1, K)).astype(np.int64),
               "det_valid": np.ones((B, K), bool)}
        return {k: torch.from_numpy(v) for k, v in out.items()} if as_tensor else out

    buffer_file = str(tmp_path / "buffer.json")
    dump({"0": []}, buffer_file)
    infos_path = str(tmp_path / "infos.pkl")
    dump([{"gt_names": []}] * n, infos_path)
    results = {}
    for depth in (1, 2, 5):
        sel = BaseSelector(budget=4, buffer_file=buffer_file, infos_origin=infos_path,
                           detector=detector, dataloader=_Loader(), device="cpu")
        results[depth] = sel.run_pool_scoring(pipeline_depth=depth)
    for depth in (2, 5):
        for k in results[1]:
            np.testing.assert_array_equal(results[depth][k], results[1][k])
    np.testing.assert_array_equal(results[1]["score_entropy"], np.arange(n, dtype=np.float32))
    assert results[1]["scores"].shape == (n, K)


def test_run_pool_scoring_cache_round_trip(tmp_path):
    n = 4
    buffer_file = str(tmp_path / "buffer.json")
    dump({"0": []}, buffer_file)
    infos_path = str(tmp_path / "infos.pkl")
    dump([{"gt_names": []}] * n, infos_path)
    calls = []

    def detector(batch):
        calls.append(1)
        z = np.zeros((n, 2), np.float32)
        return {"embedding": z, "score_entropy": z[:, 0], "scores": z, "label_preds": z,
                "det_valid": z > 0}

    cache = str(tmp_path / "cache" / "pred.npz")
    for _ in range(2):
        sel = BaseSelector(budget=1, buffer_file=buffer_file, infos_origin=infos_path,
                           detector=detector, dataloader=[{}], device="cpu")
        out = sel.run_pool_scoring(cache)
    assert len(calls) == 1 and out["embedding"].shape == (n, 2)
