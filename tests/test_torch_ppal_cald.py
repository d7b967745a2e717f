"""The PPAL / CALD pre-pass CLIs of the port (dal3d_tpu_torch/tools/
{ppal,cald}_pred_list.py, ppal_unc.py, cald_ent.py) against the JAX package
on the CPU, and the selection rounds they feed.

A tiny synthetic pool (6 frames, the production CBGS config cut to a 12.8 m
grid, tests/torch_port_utils.py::small_cfg, f32) and one set of seeded
weights, JAX's variables carried into a port checkpoint by
models/convert_flax.py:

- the prediction-list CLIs (plain and ``--augment``), fed raw points that the
  port voxelizes on the device, against JAX's predict from the same points
  in the loop of JAX's tools (y-flip of the points, boxes flipped back):
  the same tokens, detections equal as post-NMS sets (scores and boxes
  within 1e-4);
- ``ppal_unc`` and ``cald_ent`` against JAX's CLIs on the same lists: the
  JSON files equal byte for byte, the pkl files' contents equal;
- a ``PPALSelector`` round through the port's ``active_select`` (its pool
  scored by the port) and a ``CaldSelector`` round, against JAX's selectors
  on the same files and seed: the buffer JSON equal byte for byte."""
import importlib.util
import os
import pickle
import random
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu import selectors as jsel
from dal3d_tpu.data import DataLoader as JaxLoader
from dal3d_tpu.data import NuScenesDataset as JaxDataset
from dal3d_tpu.models.builder import build_detector as jax_build
from dal3d_tpu.runtime.steps import make_predict_step as jax_make_predict_step
from dal3d_tpu.utils.config import Config as JaxConfig
from dal3d_tpu_torch.data.datasets.synthetic import DEFAULT_CLASSES, make_synthetic_nuscenes
from dal3d_tpu_torch.models.builder import build_detector
from dal3d_tpu_torch.models.convert_flax import load_flax_variables
from dal3d_tpu_torch.runtime.checkpoint import save_checkpoint
from dal3d_tpu_torch.tools import (active_select, cald_ent, cald_pred_list, ppal_pred_list,
                                   ppal_unc)
from dal3d_tpu_torch.utils.config import Config
from dal3d_tpu_torch.utils.fileio import dump, load
from test_torch_predict import _randomize
from torch_port_utils import small_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIPELINE = [dict(type="LoadPointCloudFromFile", dataset="NuScenesDataset"),
            dict(type="LoadPointCloudAnnotations", with_bbox=True),
            dict(type="Preprocess", cfg=dict(mode="val", shuffle_points=False)),
            dict(type="ReformatFixedShape")]
SEED = 7
DET_KEYS = ("box3d_lidar", "scores", "label_preds", "det_valid")


def _jax_tool(name):
    """A CLI module of the JAX package's tools/ directory."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_cfg(path, info, selector):
    cfg = small_cfg("float32", pre=64, post=32)
    cfg["voxel_generator"].update(max_voxel_num=1500, bf16=False)
    cfg["test_cfg"]["score_threshold"] = 0.05
    cfg.update(max_points=40000, selector=selector,
               data=dict(samples_per_gpu=2, val=dict(
                   type="NuScenesDataset", root_path="", info_path=info, nsweeps=10,
                   class_names=DEFAULT_CLASSES, test_mode=True, pipeline=PIPELINE)))
    with open(path, "w") as f:
        for k, v in cfg.items():
            f.write(f"{k} = {v!r}\n")
    return str(path)


def _jax_pred_list(jb, variables, cfg_path, augment):
    """The loop of JAX's tools/ppal_pred_list.py on JAX's predict step."""
    cfg = JaxConfig.fromfile(cfg_path)
    val = dict(cfg.data["val"])
    ds = JaxDataset(info_path=dict(cfg.selector)["infos_origin"], root_path="",
                    nsweeps=val["nsweeps"], class_names=val["class_names"],
                    pipeline=[dict(s) for s in val["pipeline"]],
                    tasks=[dict(t) for t in cfg.tasks], max_points=cfg.max_points,
                    voxelize_host=None, test_mode=True)
    predict = jax_make_predict_step(jb)
    preds = {}
    np.random.seed(SEED)
    for batch in JaxLoader(ds, 2, shuffle=False, drop_last=False):
        pts = np.asarray(batch["points"]).copy()
        if augment:
            pts[..., 1] *= -1
        out = predict(variables["params"], variables["batch_stats"],
                      {"points": pts, "points_valid": batch["points_valid"]})
        out = {k: np.asarray(v) for k, v in out.items()}
        for i, md in enumerate(batch["metadata"]):
            if md["token"] in preds:
                continue
            det = {k: out[k][i] for k in DET_KEYS}
            if augment:
                det["box3d_lidar"] = det["box3d_lidar"].copy()
                det["box3d_lidar"][:, 1] *= -1
                det["box3d_lidar"][:, 7] *= -1
                det["box3d_lidar"][:, 8] = -det["box3d_lidar"][:, 8] + np.pi
            preds[md["token"]] = det
    return preds


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """The pool, its configs, a port checkpoint of JAX's seeded variables,
    and JAX's prediction lists (plain, augmented) from those variables."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("ppal_cald")
    info = make_synthetic_nuscenes(str(root), n_frames=6, n_logs=2, points_per_frame=3000,
                                   range_xy=6.0, max_boxes=6, seed=3)
    buffer = str(root / "buffer.json")
    ppal = _write_cfg(root / "ppal.py", info, dict(
        type="PPALSelector", budget=2, delta=1.5, buffer_file=buffer, infos_origin=info,
        diff_file=str(root / "diff_category_average.json"),
        pred_store_file=str(root / "ppal_pred.npz")))
    cald = _write_cfg(root / "cald.py", info, dict(
        type="CaldSelector", budget=2, buffer_file=buffer, infos_origin=info,
        sorted_idx_file=str(root / "cald_ent_sorted_idx.json"),
        jsdiv_file=str(root / "idx_to_jsdiv.pkl")))
    jb = jax_build(JaxConfig.fromfile(ppal))
    P = 40000
    shapes = jax.eval_shape(lambda: jb.model.init(jax.random.PRNGKey(0),
                                                  jnp.zeros((2, P, 5)), jnp.zeros((2, P), bool),
                                                  False))
    variables = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape), shapes),
                           np.random.RandomState(1))
    # a quiet head: scores spread around 0.5 (not saturated, so the top-k
    # meets no ties) and boxes near their anchors (so some match the gt)
    for conv in variables["params"]["MultiGroupHead_0"].values():
        conv["kernel"] *= np.float32(0.05)
    bundle = build_detector(Config.fromfile(ppal), device="cpu")
    load_flax_variables(bundle.model, variables)
    ckpt = str(root / "ckpt")
    save_checkpoint(ckpt, bundle.model, 1)
    jax_lists = {aug: _jax_pred_list(jb, variables, ppal, aug) for aug in (False, True)}
    yield dict(root=root, info=info, buffer=buffer, ppal=ppal, cald=cald, ckpt=ckpt,
               jax=jax_lists)
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_lists(pool):
    """The port's prediction-list CLIs on the pool, plain and --augment:
    {augment: (pkl path, returned lists)}."""
    lists = {}
    for augment in (False, True):
        out = str(pool["root"] / f"pred_list{'-aug' if augment else ''}.pkl")
        np.random.seed(SEED)
        cli = cald_pred_list if augment else ppal_pred_list
        args = [pool["cald" if augment else "ppal"], "--checkpoint", pool["ckpt"], "--out", out,
                "--cpu"] + (["--augment"] if augment else [])
        got = cli.main(args)
        with open(out, "rb") as f:
            assert pickle.load(f).keys() == got.keys()
        lists[augment] = (out, got)
    return lists


@pytest.mark.parametrize("augment", [False, True])
def test_pred_list_matches_jax(pool, port_lists, augment):
    _, got = port_lists[augment]
    want = pool["jax"][augment]
    assert list(got) == list(want) == [i["token"] for i in load(pool["info"])]
    n_dets = 0
    for token, w in want.items():
        g = got[token]
        jv, tv = w["det_valid"], g["det_valid"]
        assert jv.sum() == tv.sum()
        # matched sets: each of JAX's detections to the port's nearest box
        # (scores a few ulps apart may order two detections either way)
        jb, tb = w["box3d_lidar"][jv], g["box3d_lidar"][tv]
        near = np.abs(jb[:, None] - tb[None]).max(-1).argmin(1)
        assert len(set(near.tolist())) == len(near)
        np.testing.assert_allclose(tb[near], jb, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g["scores"][tv][near], w["scores"][jv], rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(g["label_preds"][tv][near], w["label_preds"][jv])
        n_dets += int(jv.sum())
    assert n_dets > 20


def test_ppal_round_matches_jax(pool, port_lists, monkeypatch):
    root = pool["root"]
    pred_list = port_lists[False][0]
    dump({"0": [0, 1]}, pool["buffer"])
    out = {}
    for side in ("jax", "torch"):
        d = root / f"ppal_{side}"
        d.mkdir()
        monkeypatch.chdir(d)  # both write dict_p_iou.pkl to the working directory
        out[side] = str(d / "diff.json")
        args = [pool["ppal"], "--pred_list", pred_list, "--out", out[side]]
        if side == "jax":
            monkeypatch.setattr(sys, "argv", ["ppal_unc.py"] + args)
            _jax_tool("ppal_unc").main()
        else:
            ppal_unc.main(args + ["--cpu"])
    assert open(out["torch"], "rb").read() == open(out["jax"], "rb").read()
    weights = load(out["torch"])
    assert set(weights) == set(DEFAULT_CLASSES)
    assert min(weights.values()) < 3.0  # a matched class, below the default weight
    with open(root / "ppal_jax" / "dict_p_iou.pkl", "rb") as f:
        want = pickle.load(f)
    with open(root / "ppal_torch" / "dict_p_iou.pkl", "rb") as f:
        got = pickle.load(f)
    assert repr(got) == repr(want) and len(got) > 0

    # the selection round: the port's CLI scores the pool; JAX's selector
    # reads the same scores, difficulty weights and seed
    shutil.copy(out["torch"], root / "diff_category_average.json")
    active_select.main([pool["ppal"], "--checkpoint", pool["ckpt"], "--cpu",
                        "--seed", str(SEED)])
    got_buffer = open(pool["buffer"], "rb").read()
    dump({"0": [0, 1]}, pool["buffer"])
    random.seed(SEED)
    np.random.seed(SEED)
    sel = jsel.build_selector(dict(Config.fromfile(pool["ppal"])["selector"]))
    sel.select_samples()
    sel.dump_file()
    assert open(pool["buffer"], "rb").read() == got_buffer
    assert len(load(pool["buffer"])) == 2


def test_cald_round_matches_jax(pool, port_lists, monkeypatch):
    root = pool["root"]
    plain, aug = port_lists[False][0], port_lists[True][0]
    out = {}
    for side in ("jax", "torch"):
        d = root / f"cald_{side}"
        d.mkdir()
        out[side] = (str(d / "sorted.json"), str(d / "jsdiv.pkl"))
        args = [pool["cald"], "--pred_list", plain, "--pred_list_aug", aug,
                "--sorted_out", out[side][0], "--jsdiv_out", out[side][1]]
        if side == "jax":
            monkeypatch.setattr(sys, "argv", ["cald_ent.py"] + args)
            _jax_tool("cald_ent").main()
        else:
            cald_ent.main(args + ["--cpu"])
    assert open(out["torch"][0], "rb").read() == open(out["jax"][0], "rb").read()
    with open(out["jax"][1], "rb") as f:
        want = pickle.load(f)
    with open(out["torch"][1], "rb") as f:
        got = pickle.load(f)
    assert got == want and len(got) == 6 and min(got.values()) > 0
    order = load(out["torch"][0])
    assert sorted(order) == list(range(6)) and order != sorted(order)

    # the selection round on those files
    shutil.copy(out["torch"][0], root / "cald_ent_sorted_idx.json")
    shutil.copy(out["torch"][1], root / "idx_to_jsdiv.pkl")
    dump({"0": [0, 1]}, pool["buffer"])
    active_select.main([pool["cald"], "--cpu", "--seed", str(SEED)])
    got_buffer = open(pool["buffer"], "rb").read()
    dump({"0": [0, 1]}, pool["buffer"])
    random.seed(SEED)
    np.random.seed(SEED)
    sel = jsel.build_selector(dict(Config.fromfile(pool["cald"])["selector"]))
    sel.select_samples()
    sel.dump_file()
    assert open(pool["buffer"], "rb").read() == got_buffer
    assert len(load(pool["buffer"])["2"]) >= 1
