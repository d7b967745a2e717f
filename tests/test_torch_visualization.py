"""The visualisation modules and CLIs of the PyTorch port against the JAX
package's on the CPU: ``boxes_to_corners_3d``, ``range_image`` and
``project_boxes_to_image`` bit for bit; ``bev_plot`` and ``plot_3d_scene``
the same RGBA pixels on the same inputs; ``analyze_logs`` parses the
interval lines of the port's ``Trainer`` into JAX's rows;
``lidar_visualize --detections`` (a seeded checkpoint's ``dist_test
--out``) and ``cam_vis`` write the same PNG files as JAX's CLIs on the same
synthetic sets, and ``lidar_visualize --checkpoint --cpu`` predicts the
detections of that pkl."""
import importlib.util
import os
import pickle
import runpy
import sys

import numpy as np
import pytest
import torch

from dal3d_tpu.visualization import simplevis as jsv
from dal3d_tpu.visualization import vis3d as jv3
from dal3d_tpu_torch.data.datasets.synthetic import DEFAULT_CLASSES, make_synthetic_nuscenes
from dal3d_tpu_torch.tools import analyze_logs, cam_vis, dist_test, lidar_visualize
from dal3d_tpu_torch.visualization import simplevis as tsv
from dal3d_tpu_torch.visualization import vis3d as tv3
from test_torch_camera_branch import few_threads  # noqa: F401
from test_torch_trainer import _write_cfg

pytestmark = pytest.mark.usefixtures("few_threads")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAM_CLASSES = ["car", "pedestrian", "traffic_cone"]


def _boxes(seed, n=7):
    rng = np.random.RandomState(seed)
    b = np.zeros((n, 9), np.float32)
    b[:, :2] = rng.uniform(-20, 20, (n, 2))
    b[:, 2] = rng.uniform(-2, 0, n)
    b[:, 3:6] = rng.uniform(0.5, 5, (n, 3))
    b[:, 8] = rng.uniform(-np.pi, np.pi, n)
    return b


def _points(seed, n=4000):
    rng = np.random.RandomState(seed)
    p = rng.uniform(-30, 30, (n, 5)).astype(np.float32)
    p[:, 2] = rng.uniform(-3, 2, n)
    p[:5] = 0  # the origin: range 0
    return p


def test_geometry_is_bit_equal_to_jax():
    b = _boxes(0)
    np.testing.assert_array_equal(tv3.boxes_to_corners_3d(b), jv3.boxes_to_corners_3d(b))
    p = _points(1)
    got, want = tv3.range_image(p), jv3.range_image(p)
    assert got.dtype == want.dtype and (got > 0).sum() > 100
    np.testing.assert_array_equal(got, want)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    ang = 0.3
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [-np.sin(ang), 0, np.cos(ang)], [0, -1, 0]])
    t = np.array([0.5, 0.1, 1.6])
    for g, w in zip(tv3.project_boxes_to_image(b, K, R, t), jv3.project_boxes_to_image(b, K, R, t)):
        np.testing.assert_array_equal(g, w)


def _pixels(ax):
    ax.figure.canvas.draw()
    px = np.asarray(ax.figure.canvas.buffer_rgba()).copy()
    tv3._agg().close(ax.figure)
    return px


def test_bev_and_3d_plots_give_jax_pixels():
    p, gt, pred = _points(2, n=1500), _boxes(3), _boxes(4)[:4]
    got = _pixels(tsv.bev_plot(p, gt, pred, pc_range=(-32, -32, 32, 32)))
    want = _pixels(jsv.bev_plot(p, gt, pred, pc_range=(-32, -32, 32, 32)))
    assert got.shape == want.shape and np.array_equal(got, want)
    assert len(np.unique(got.reshape(-1, 4), axis=0)) > 3  # points and both box colours
    got = _pixels(tv3.plot_3d_scene(p, gt, pred, max_points=1000))  # a seeded draw
    want = _pixels(jv3.plot_3d_scene(p, gt, pred, max_points=1000))
    assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def checkpointed(tmp_path_factory):
    """A synthetic 4-frame set, a config on the tiny grid, a checkpoint of
    seeded random weights, and its ``dist_test --out`` detections (numpy's
    global generator seeded: the sweep draw of a frame uses it)."""
    from dal3d_tpu_torch.models.builder import build_detector
    from dal3d_tpu_torch.runtime.checkpoint import save_checkpoint
    from dal3d_tpu_torch.utils.config import Config

    root = tmp_path_factory.mktemp("vis")
    info = make_synthetic_nuscenes(str(root), n_frames=4, n_logs=2, points_per_frame=600,
                                   range_xy=6.0, max_boxes=6, seed=5)
    work = str(root / "work")
    cfg = _write_cfg(root / "cfg.py", info, work)
    save_checkpoint(work, build_detector(Config.fromfile(cfg), device="cpu", seed=3).model, 1)
    dets = str(root / "dets.pkl")
    np.random.seed(0)
    dist_test.main([cfg, "--checkpoint", work, "--work_dir", str(root / "eval"), "--out", dets,
                    "--cpu"])
    return root, cfg, work, dets


def _jax_cli(name, argv, monkeypatch):
    """Runs JAX's ``tools/<name>.py`` as a script with ``argv``."""
    monkeypatch.setattr(sys, "argv", [name] + argv)
    runpy.run_path(os.path.join(REPO, "tools", f"{name}.py"), run_name="__main__")


def test_analyze_logs_parses_the_port_trainer_log_as_jax(checkpointed, capsys):
    """The port's ``Trainer`` writes its interval lines (a stub train step
    with varying logs, the OneCycle learning rate) to a log file; JAX's
    ``tools/analyze_logs.py`` and the port's parse it into the same rows and
    print the same epoch statistics."""
    import logging

    from dal3d_tpu_torch.models.builder import build_detector
    from dal3d_tpu_torch.runtime.trainer import Trainer
    from dal3d_tpu_torch.solver.optim import OneCycleSchedule
    from dal3d_tpu_torch.utils.config import Config

    root, cfg, _, _ = checkpointed
    log = str(root / "trainer.log")
    logger = logging.getLogger("test_torch_visualization.trainer")
    handler = logging.FileHandler(log)
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    tr = Trainer(build_detector(Config.fromfile(cfg), device="cpu"), None, str(root / "tr"),
                 one_cycle_cfg=OneCycleSchedule(total_steps=6), logger=logger, log_interval=1)
    tr._capacity_checked = True
    it = iter(range(100))

    def step(batch):
        i = next(it)
        return {k: torch.tensor(v) for k, v in dict(
            loss=1.5 / (i + 1), loc_loss=1.0 / (i + 1), cls_loss=0.5 / (i + 1),
            grad_norm=3.0 + i, num_pos=7.0).items()}

    tr.train_step = step
    for _ in range(2):
        tr.train_epoch([{}] * 3)
    handler.close()
    logger.removeHandler(handler)
    spec = importlib.util.spec_from_file_location("jax_analyze_logs",
                                                  os.path.join(REPO, "tools", "analyze_logs.py"))
    jal = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jal)
    want = jal.parse(log)
    assert [(r["epoch"], r["iter"]) for r in want] == [(e, i) for e in (1, 2) for i in (1, 2, 3)]
    assert want[-1]["loss"] == pytest.approx(0.25, abs=1e-4) and want[2]["lr"] > 0
    got = analyze_logs.main(["cal_train_time", log])
    assert got == want
    printed = capsys.readouterr().out
    jal.cal_train_time(want)
    assert printed == capsys.readouterr().out and "mean_iter_time" in printed


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        with open(os.path.join(a, n), "rb") as f, open(os.path.join(b, n), "rb") as g:
            assert f.read() == g.read(), n
    return names


def test_lidar_visualize_cli_writes_jax_files(checkpointed, monkeypatch):
    from dal3d_tpu_torch.utils.config import Config

    root, cfg, work, dets = checkpointed
    # the figures read points, GT and the pkl's boxes only: both CLIs run
    # on raw points (JAX's dataset would build its sparse plans under jit)
    points_cfg = str(root / "cfg_points.py")
    with open(cfg) as f, open(points_cfg, "w") as g:
        g.write(f.read() + "voxelize_host = False\n")
    args = ["--num", "1", "--detections", dets, "--score_thresh", "0.0", "--range_view"]
    np.random.seed(0)
    _jax_cli("lidar_visualize", [points_cfg, "--out_dir", str(root / "vis_jax"), "--cpu"] + args,
             monkeypatch)
    np.random.seed(0)
    recs = lidar_visualize.main([points_cfg, "--out_dir", str(root / "vis_port"), "--cpu"]
                                + args)
    names = _same_files(root / "vis_jax", root / "vis_port")
    assert "gallery.png" in names and len(names) == 3 + 1
    with open(dets, "rb") as f:
        pkl = pickle.load(f)
    assert sum(len(r["pred_boxes"]) for r in recs) > 0
    # the same frames predicted from the checkpoint (--cpu) a frame at a time:
    # the pkl's boxes (predicted two frames a batch) within 1e-4
    np.random.seed(0)
    live = lidar_visualize.frame_records(
        Config.fromfile(cfg), lidar_visualize.parse_args([cfg, "--num", "1", "--checkpoint", work,
                                    "--score_thresh", "0.0", "--cpu"]),
        torch.device("cpu"))
    for r, q in zip(live, recs):
        d = pkl[r["token"]]
        assert r["token"] == q["token"] and np.array_equal(r["points"], q["points"])
        np.testing.assert_allclose(r["pred_boxes"], d["box3d_lidar"][d["det_valid"]],
                                   rtol=1e-4, atol=1e-4)


def test_cam_vis_cli_writes_jax_files(tmp_path, monkeypatch):
    info = make_synthetic_nuscenes(str(tmp_path / "cam"), n_frames=2, with_camera=True,
                                   image_hw=(48, 72), classes=CAM_CLASSES, points_per_frame=2000)
    cfg = tmp_path / "cam_cfg.py"
    with open(cfg, "w") as f:
        f.write(f"import sys\nsys.path.insert(0, {os.path.join(REPO, 'configs')!r})\n"
                "from bevfusion_cl_synthetic import *  # noqa: F401,F403\n"
                # the camera stages' draws fixed (each takes a fresh RandomState)
                "_p = [dict(s) for s in train_pipeline]\n"
                "_p[4].update(resize_lim=(0.5, 0.5), rot_lim=(0.0, 0.0), rand_flip=False)\n"
                "_p[5].update(prob=0.0)\n"
                f"data = dict(data, train=dict(data['train'], info_path={info!r}, "
                "root_path='', pipeline=_p))\n")
    np.random.seed(0)
    _jax_cli("cam_vis", [str(cfg), "--out_dir", str(tmp_path / "cv_jax"), "--cpu"],
             monkeypatch)
    np.random.seed(0)
    views = cam_vis.main([str(cfg), "--out_dir", str(tmp_path / "cv_port")])
    assert len(_same_files(tmp_path / "cv_jax", tmp_path / "cv_port")) == 2
    assert len(views) == 2 and views[0]["images"].shape[0] == 6
    assert sum(len(v["gt_boxes"]) for v in views) > 0


def test_lidar_visualize_without_cpu_needs_a_gpu(checkpointed, monkeypatch):
    root, cfg, work, _ = checkpointed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lidar_visualize.main([cfg, "--checkpoint", work, "--out_dir", str(root / "gpu")])
    assert not os.path.exists(root / "gpu")
