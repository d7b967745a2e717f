"""The port's evaluation runtime (dal3d_tpu_torch/runtime/evaluation.py) and
its CLIs on the CPU (plain versions of the kernels), against the JAX
package's evaluation of the same detections:

- ``predict_dataset`` keeps one detection set per frame token: the padded
  repeats of a test-mode loader's last batch are dropped;
- ``kitti_style_eval`` of the port's detections equals JAX's
  ``kitti_style_eval`` of the same detections;
- ``dist_test --cpu`` on a tiny synthetic set writes ``--out`` and a
  ``results_nusc.json`` equal to JAX's conversion of the same detections,
  and ``test`` gives the same result;
- ``--torch_init`` gives both CLIs the result of the checkpoint whose
  weights it holds; a config that asks for the approximate top-k runs
  through both CLIs and gives the exact top-k's detections (what JAX's
  approximate branch computes off the TPU); without ``--cpu`` the CLIs need
  a GPU."""
import json
import os
import pickle

import numpy as np
import pytest
import torch

from dal3d_tpu.data import NuScenesDataset as JaxDataset
from dal3d_tpu.runtime import evaluation as jev
from dal3d_tpu_torch.data import DataLoader
from dal3d_tpu_torch.data.datasets.synthetic import DEFAULT_CLASSES, make_synthetic_nuscenes
from dal3d_tpu_torch.models.builder import build_detector, eval_test_cfg
from dal3d_tpu_torch.runtime import evaluation as tev
from dal3d_tpu_torch.runtime.checkpoint import save_checkpoint
from dal3d_tpu_torch.tools import dist_test
from dal3d_tpu_torch.tools import test as test_cli
from dal3d_tpu_torch.utils.config import Config
from jax_eval_ref import jax_ious, precomputed_jax_iou
from torch_port_utils import small_cfg

PIPELINE = [dict(type="LoadPointCloudFromFile", dataset="NuScenesDataset"),
            dict(type="LoadPointCloudAnnotations", with_bbox=True),
            dict(type="Preprocess", cfg=dict(mode="val", shuffle_points=False)),
            dict(type="ReformatFixedShape")]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def evalset(tmp_path_factory):
    """A 5-frame synthetic val set (odd: the last batch of 2 is padded), a
    config on the tiny grid pointed at it, and a checkpoint of seeded random
    weights."""
    root = tmp_path_factory.mktemp("nusc_eval")
    info = make_synthetic_nuscenes(str(root), n_frames=5, n_logs=2, points_per_frame=3000,
                                   range_xy=6.0, max_boxes=6, seed=9, split="val")
    cfg = small_cfg("float32")
    cfg["voxel_generator"].update(max_voxel_num=1500, bf16=False)
    cfg.update(max_points=40000, work_dir=str(root / "work"),
               data=dict(samples_per_gpu=2, val=dict(
                   type="NuScenesDataset", root_path="", info_path=info, nsweeps=10,
                   class_names=DEFAULT_CLASSES, test_mode=True, pipeline=PIPELINE)))
    path = str(root / "cfg.py")
    with open(path, "w") as f:
        for k, v in cfg.items():
            f.write(f"{k} = {v!r}\n")
    ckpt = str(root / "ckpt")
    save_checkpoint(ckpt, build_detector(Config.fromfile(path), device="cpu", seed=3).model, 1)
    return root, info, path, ckpt


@pytest.fixture(scope="module")
def cli_run(evalset):
    root, info, cfg, ckpt = evalset
    out = str(root / "dets.pkl")
    work = str(root / "work_dist")
    result = dist_test.main([cfg, "--checkpoint", ckpt, "--work_dir", work, "--out", out,
                             "--cpu"])
    with open(out, "rb") as f:
        dets = pickle.load(f)
    return result, dets, work


def test_predict_dataset_drops_the_padded_tail(evalset):
    _, info, cfg_path, ckpt = evalset
    cfg = Config.fromfile(cfg_path)
    dataset = tev.build_val_dataset(cfg)
    loader = DataLoader(dataset, 2, shuffle=False, drop_last=False)
    seen = []

    def predict(batch):
        seen.append(len(batch["voxel_valid"]))
        b = len(batch["voxel_valid"])
        k = len(seen)
        return {"box3d_lidar": torch.full((b, 3, 9), float(k)),
                "scores": torch.full((b, 3), 0.5), "label_preds": torch.zeros(b, 3),
                "det_valid": torch.ones(b, 3, dtype=torch.bool)}

    dets = tev.predict_dataset(predict, loader)
    tokens = [i["token"] for i in dataset.infos]
    assert seen == [2, 2, 2] and list(dets) == tokens  # 6 slots, 5 frames
    assert float(dets[tokens[-1]]["box3d_lidar"][0, 0]) == 3.0  # from the last batch


def test_dist_test_writes_detections_and_jax_submission(evalset, cli_run):
    root, info, _, _ = evalset
    result, dets, work = cli_run
    jds = JaxDataset(info_path=info, class_names=DEFAULT_CLASSES, test_mode=True)
    assert list(dets) == [i["token"] for i in jds.infos]
    assert sum(int(d["det_valid"].sum()) for d in dets.values()) > 0
    with open(os.path.join(work, "results_nusc.json")) as f:
        got = json.load(f)
    want = json.loads(json.dumps(jds.convert_detections_to_nusc(dets)))
    assert got == want
    assert "devkit unavailable" in result["results"]["nusc"]
    assert set(result["kitti_style"]) == {"mAP_bev", "mAP_3d"}
    log = open(os.path.join(work, "test.log")).read()
    assert "top-k prefilter: exact" in log and "evaluation:" in log


def test_kitti_style_eval_equals_jax(evalset, cli_run):
    _, info, cfg_path, _ = evalset
    _, dets, _ = cli_run
    # move some detections onto the gt boxes, so that matches count
    dets = {k: {f: np.array(v) for f, v in d.items()} for k, d in dets.items()}
    jds = JaxDataset(info_path=info, class_names=DEFAULT_CLASSES, test_mode=True)
    for i, info_ in enumerate(jds.infos):
        d, n = dets[info_["token"]], len(info_["gt_boxes"]) - i % 2
        d["box3d_lidar"][:n] = info_["gt_boxes"][:n] + np.float32(0.1 * (i + 1))
        d["label_preds"][:n] = [DEFAULT_CLASSES.index(c) for c in info_["gt_names"][:n]]
        d["det_valid"][:n] = True
    tds = tev.build_val_dataset(Config.fromfile(cfg_path))
    got = tev.kitti_style_eval(tds, dets, device="cpu")
    from dal3d_tpu.eval.matched_iou import detections_to_frames, infos_to_frames

    preds = list(detections_to_frames(dets, DEFAULT_CLASSES).values())
    gts = list(infos_to_frames(jds.infos).values())
    with precomputed_jax_iou(*jax_ious(preds, gts)):
        want = jev.kitti_style_eval(jds, dets)
    assert got == want and got["mAP_bev"] > 0


def test_test_cli_gives_the_dist_test_result(evalset, cli_run):
    root, _, cfg, ckpt = evalset
    result, _, _ = cli_run
    work = str(root / "work_test")
    assert test_cli.main([cfg, "--checkpoint", ckpt, "--work_dir", work, "--cpu"]) == dict(
        result, results={"nusc": result["results"]["nusc"].replace("work_dist", "work_test")})


@pytest.fixture(scope="module")
def seeded_run(evalset):
    """``dist_test`` on the checkpoint with numpy's global generator seeded
    (the sweep draw of a frame uses it): (result, detections)."""
    root, _, cfg, ckpt = evalset
    np.random.seed(0)
    ref_out = str(root / "work_ti_ref.pkl")
    result = dist_test.main([cfg, "--checkpoint", ckpt, "--work_dir", str(root / "work_ti_ref"),
                             "--out", ref_out, "--cpu"])
    with open(ref_out, "rb") as f:
        return result, pickle.load(f)


def test_torch_init_gives_the_checkpoint_result(evalset, seeded_run):
    """``--torch_init`` (refused before the port's det3d loader): the
    checkpoint's weights written as a det3d npz give both CLIs the
    checkpoint's result, and win over a ``--checkpoint`` given beside them."""
    from dal3d_tpu_torch.models.convert_second import (save_raw_state_dict_npz,
                                                       to_det3d_state_dict)
    from dal3d_tpu_torch.runtime.checkpoint import load_checkpoint

    root, _, cfg, ckpt = evalset
    result, dets = seeded_run
    model = build_detector(Config.fromfile(cfg), device="cpu").model
    load_checkpoint(ckpt, model)
    npz = str(root / "det3d.npz")
    save_raw_state_dict_npz(to_det3d_state_dict(model.state_dict()), npz)
    other = str(root / "other_ckpt")
    save_checkpoint(other, build_detector(Config.fromfile(cfg), device="cpu", seed=5).model, 1)
    for cli, extra, name in ((dist_test, [], "work_ti_dist"),
                             (test_cli, ["--checkpoint", other], "work_ti_test")):
        work, out = str(root / name), str(root / f"{name}.pkl")
        np.random.seed(0)
        got = cli.main([cfg, "--torch_init", npz, "--work_dir", work, "--out", out, "--cpu"]
                       + extra)
        assert got == dict(result, results={"nusc": result["results"]["nusc"].replace(
            "work_ti_ref", name)})
        with open(out, "rb") as f:
            got_dets = pickle.load(f)
        for token, d in dets.items():
            for k, v in d.items():
                np.testing.assert_array_equal(got_dets[token][k], v, err_msg=k)
        log = open(os.path.join(work, "test.log")).read()
        assert f"initialized from converted torch checkpoint {npz}" in log


def test_unported_options_are_refused(evalset, monkeypatch):
    root, _, cfg, ckpt = evalset
    with pytest.raises(SystemExit, match="one of --checkpoint / --torch_init"):
        test_cli.main([cfg, "--cpu"])
    assert eval_test_cfg({"test_cfg": {"nms": {"use_approx_topk": True}}})["nms"][
        "use_approx_topk"] is True  # accepted since the port's A9.i
    assert eval_test_cfg({"test_cfg": {"nms": {}}})["nms"]["use_approx_topk"] is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cli in (test_cli, dist_test):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([cfg, "--checkpoint", ckpt, "--work_dir", str(root / "gpu")])
    assert not os.path.exists(root / "gpu")


def test_approx_topk_config_runs_through_test_and_dist_test(evalset, seeded_run):
    """``test_cfg.nms.use_approx_topk = True``: ``dist_test`` and ``test``
    run, log JAX's word for the flag, and give the exact top-k's
    detections (XLA's approx_max_k is the exact top k off the TPU;
    tests/test_torch_losses.py holds the predict against JAX's approximate
    branch)."""
    root, _, cfg, ckpt = evalset
    approx = str(root / "cfg_approx.py")
    with open(cfg) as f, open(approx, "w") as g:
        g.write(f.read() + "test_cfg = dict(test_cfg, nms=dict(test_cfg['nms'], "
                "use_approx_topk=True))\n")
    assert Config.fromfile(approx)["test_cfg"]["nms"]["use_approx_topk"] is True
    runs = {"exact": seeded_run[1]}
    assert "top-k prefilter: exact" in open(root / "work_ti_ref" / "test.log").read()
    for tag, cli in (("approx", dist_test), ("approx_test", test_cli)):
        work, out = str(root / f"work_{tag}"), str(root / f"{tag}.pkl")
        np.random.seed(0)  # the sweep draw of a frame uses numpy's global generator
        cli.main([approx, "--checkpoint", ckpt, "--work_dir", work, "--out", out, "--cpu"])
        with open(out, "rb") as f:
            runs[tag] = pickle.load(f)
        assert "top-k prefilter: approx" in open(os.path.join(work, "test.log")).read()
    assert sum(int(d["det_valid"].sum()) for d in runs["exact"].values()) > 0
    for tag in ("approx", "approx_test"):
        assert list(runs[tag]) == list(runs["exact"])
        for token, d in runs["exact"].items():
            for k, v in d.items():
                np.testing.assert_array_equal(runs[tag][token][k], v, err_msg=k)
