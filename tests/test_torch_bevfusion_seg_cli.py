"""``configs/bevfusion_cl_synthetic.py`` through the port's BEVFusion training
CLI as written, on the CPU (plain versions of the kernels): camera + lidar
with map segmentation, on a 4-frame synthetic camera set written at the
config's own relative paths. One epoch; the map targets come from the
config's ``LoadBEVSegmentation`` stage through the loader into the step;
``seg_loss`` is logged finite and above 0, and the checkpoint carries the
segmentation head."""
import os
import re

import numpy as np
import pytest
import torch

from dal3d_tpu_torch.data.datasets.synthetic import make_synthetic_nuscenes
from dal3d_tpu_torch.runtime.checkpoint import latest_epoch
from dal3d_tpu_torch.tools import train_bevfusion

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_map_seg_config_as_written(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    info = make_synthetic_nuscenes("data/synthetic_cam", n_frames=4, n_logs=1,
                                   points_per_frame=3000, range_xy=7.0, max_boxes=6, seed=4,
                                   with_camera=True, image_hw=(64, 96),
                                   classes=["car", "pedestrian", "traffic_cone"])
    assert info == "data/synthetic_cam/infos_train_10sweeps_withvelo.pkl"
    r = train_bevfusion.main([os.path.join(CONFIGS, "bevfusion_cl_synthetic.py"), "--cpu"])
    model = r["bundle"].model
    steps = r["optimizer"].count  # the train set's CBGS resampling sets the epoch's length
    assert model.with_camera and model.seg_head is not None and steps >= 2
    work = "work_dirs/bevfusion_cl_synthetic"
    assert latest_epoch(work) == 1
    assert np.isfinite(r["logs"]["seg_loss"]) and r["logs"]["seg_loss"] > 0
    log = open(os.path.join(work, "train.log")).read()
    seg = [float(x) for x in re.findall(r" seg ([0-9.]+)\)", log)]
    assert len(seg) == steps // 2 and all(np.isfinite(x) and x > 0 for x in seg)  # interval 2
    sd = torch.load(os.path.join(work, "checkpoints", "epoch_1.pth"), map_location="cpu",
                    weights_only=False)
    assert any(k.startswith("seg_head.") for k in sd["state_dict"])
