"""The training CLI of the PyTorch port on the CPU (plain versions of the
kernels): ``python -m dal3d_tpu_torch.tools.train`` on a small synthetic
labeled set trains an epoch, writes a checkpoint, resumes from it with the
step count and the schedule carried on, and the selection CLI loads the
result; a workflow with a val phase evaluates after the epoch; a GT-AUG
database that exists is pasted from (with ``--budget``, the subset's);
``--torch_init`` starts from a converted det3d checkpoint; every option that
is not ported yet raises and names its ROADMAP item."""
import ast
import os
import re

import numpy as np
import pytest
import torch

from dal3d_tpu_torch.data.create_gt_database import create_groundtruth_database
from dal3d_tpu_torch.data.datasets.synthetic import DEFAULT_CLASSES, make_synthetic_nuscenes
from dal3d_tpu_torch.runtime.trainer import LogBuffer
from dal3d_tpu_torch.solver.optim import OneCycleSchedule, one_cycle_lr
from dal3d_tpu_torch.tools import active_select, train
from dal3d_tpu_torch.utils.fileio import dump, load
from torch_port_utils import small_cfg


def _pipeline(mode, extra=None):
    prep = dict(mode=mode, shuffle_points=mode == "train")
    if mode == "train":
        prep.update(global_rot_noise=[-0.3925, 0.3925], global_scale_noise=[0.95, 1.05],
                    class_names=DEFAULT_CLASSES, **(extra or {}))
    return [dict(type="LoadPointCloudFromFile", dataset="NuScenesDataset"),
            dict(type="LoadPointCloudAnnotations", with_bbox=True),
            dict(type="Preprocess", cfg=prep),
            dict(type="ReformatFixedShape")]


def _write_cfg(path, info_path, work_dir, **over):
    cfg = small_cfg("float32")
    cfg["voxel_generator"].update(max_voxel_num=1500, bf16=False)
    common = dict(type="NuScenesDataset", root_path="", info_path=info_path, nsweeps=10,
                  class_names=DEFAULT_CLASSES)
    cfg.update(
        max_points=40000,
        data=dict(samples_per_gpu=2, workers_per_gpu=1,
                  train=dict(common, pipeline=_pipeline("train", over.pop("prep", None))),
                  val=dict(common, test_mode=True, pipeline=_pipeline("val"))),
        optimizer=dict(TYPE="adam", VALUE=dict(amsgrad=0.0, wd=0.01)),
        optimizer_config=dict(grad_clip=dict(max_norm=35, norm_type=2)),
        lr_config=dict(type="one_cycle", lr_max=0.002, moms=[0.95, 0.85], div_factor=10.0,
                       pct_start=0.4),
        checkpoint_config=dict(interval=1), log_config=dict(interval=1),
        total_epochs=2, workflow=[("train", 2), ("val", 1)], work_dir=work_dir,
        selector=dict(type="FeatureSelector", budget=2,
                      buffer_file=os.path.join(work_dir, "buffer.json"),
                      infos_origin=info_path,
                      pred_store_file=os.path.join(work_dir, "pred.npz")))
    cfg.update(over)
    with open(path, "w") as f:
        for k, v in cfg.items():
            f.write(f"{k} = {v!r}\n")
    return str(path)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The test lane runs several workers side by side; with a full set of
    intra-op threads in each (and the loader thread beside them) they fight
    for the cores and the run takes many times longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def labeled(tmp_path_factory):
    root = tmp_path_factory.mktemp("nusc_cli")
    info = make_synthetic_nuscenes(str(root), n_frames=4, n_logs=2, points_per_frame=3000,
                                   range_xy=6.0, max_boxes=6, seed=5)
    return root, info


def test_cli_trains_checkpoints_resumes_and_feeds_selection(labeled):
    root, info = labeled
    work = str(root / "work")
    cfg = _write_cfg(root / "cfg.py", info, work)
    tr = train.main([cfg, "--work_dir", work, "--epochs", "1", "--no_validate", "--cpu",
                     "--seed", "0"])
    steps = tr.step
    assert steps >= 2 and tr.epoch == 1 and tr.optimizer.count == steps
    ckpt = torch.load(os.path.join(work, "checkpoints", "epoch_1.pth"), weights_only=True)
    assert ckpt["meta"] == {"epoch": 1, "global_step": steps}
    assert ckpt["optimizer"]["count"] == steps
    assert set(ckpt["optimizer"]["mu"]) == {n for n, _ in tr.bundle.model.named_parameters()}
    log = open(os.path.join(work, "train.log")).read()
    lines = re.findall(r"Epoch \[1\]\[(\d+)\] lr: ([0-9.]+), time: .* loss: ([0-9.]+) "
                       r"\(loc [0-9.]+ / cls [0-9.]+\), grad_norm: ([0-9.]+), num_pos: (\d+)", log)
    assert [int(x[0]) for x in lines] == list(range(1, steps + 1))  # log interval 1
    lr_fn = one_cycle_lr(OneCycleSchedule(total_steps=steps))
    assert float(lines[0][1]) == pytest.approx(lr_fn(1), abs=6e-6)
    assert all(np.isfinite(float(x[2])) and float(x[3]) > 0 for x in lines)
    assert sum(int(x[4]) for x in lines) > 0
    w1 = {k: v.clone() for k, v in tr.bundle.model.state_dict().items()}

    # resume: the step count, the optimizer's count and the weights carry on
    tr2 = train.main([cfg, "--work_dir", work, "--epochs", "2", "--no_validate", "--cpu",
                      "--seed", "0", "--resume_from", work])
    assert tr2.epoch == 2 and tr2.step == 2 * steps and tr2.optimizer.count == 2 * steps
    assert os.path.exists(os.path.join(work, "checkpoints", "epoch_2.pth"))
    log = open(os.path.join(work, "train.log")).read()
    assert f"resumed from epoch 1 (step {steps})" in log and "Epoch [2][1] lr:" in log
    moved = max(float((tr2.bundle.model.state_dict()[k] - v).abs().max()) for k, v in w1.items())
    assert moved > 0

    # warm start: the whole saved state, the step back at 0
    tr3 = train.main([cfg, "--work_dir", str(root / "warm"), "--epochs", "1", "--no_validate",
                      "--cpu", "--seed", "0", "--load_from", work])
    assert tr3.step == steps and tr3.optimizer.count == 3 * steps

    # the selection CLI reads the trained checkpoint
    dump({"0": []}, os.path.join(work, "buffer.json"))
    active_select.main([cfg, "--checkpoint", work, "--cpu", "--seed", "1"])
    scores = dict(np.load(os.path.join(work, "pred.npz")))
    assert scores["embedding"].shape == (4, 512) and np.isfinite(scores["embedding"]).all()
    assert len(load(os.path.join(work, "buffer.json"))["2"]) >= 1


def test_cli_without_cpu_flag_needs_a_gpu(labeled, monkeypatch):
    root, info = labeled
    cfg = _write_cfg(root / "cfg_gpu.py", info, str(root / "work_gpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main([cfg, "--no_validate"])
    assert not os.path.exists(root / "work_gpu")


@pytest.mark.parametrize("case,item", [
    ("n_model", "A11"), ("kitti_dataset", "A9.g"), ("lyft_dataset", "A9.g")])
def test_unported_options_raise_with_their_roadmap_item(labeled, case, item):
    """What the CLI still refuses: ``--n_model > 1`` (the estimator configs
    and the partial-label dataset run since the estimator slice:
    tests/test_torch_partial.py). The KITTI and Lyft datasets, refused
    until their slice (ROADMAP A9.g), now train a step: two frames of the
    labeled set, as a KITTI set (``make_synthetic_kitti``: 4-feature
    points, fed raw as JAX's KITTI loader feeds them) and under
    ``dataset_type = "LYFT"`` (the CBGS resampling over cars keeps the two
    frames)."""
    root, info = labeled
    work = str(root / f"work_{case}")
    args, over = ["--cpu", "--no_validate"], {}
    frames = [i for i in load(info) if "car" in list(i["gt_names"])][:2]
    two = str(root / f"two_{case}.pkl")
    dump(frames, two)
    if case == "n_model":
        args += ["--n_model", "2"]
    elif case == "kitti_dataset":
        from dal3d_tpu_torch.data.datasets.synthetic import make_synthetic_kitti

        kitti = make_synthetic_kitti(two, str(root / "kitti"))
        over = dict(dataset_type="KittiDataset")
    elif case == "lyft_dataset":
        over = dict(dataset_type="LYFT")
    cfg = _write_cfg(root / f"cfg_{case}.py", kitti if case == "kitti_dataset" else two,
                     work, **over)
    if case == "n_model":
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            train.main([cfg, "--work_dir", work] + args)
        assert not os.path.exists(os.path.join(work, "checkpoints"))
        return
    if case == "kitti_dataset":
        with open(cfg, "a") as f:  # 4 point features; Preprocess reads the KITTI labels
            f.write("model['reader']['num_input_features'] = 4\n"
                    "model['backbone']['num_input_features'] = 4\n"
                    "data['train']['class_names'] = ['car']\n")
    else:
        with open(cfg, "a") as f:
            f.write("data['train']['class_names'] = ['car']\n")
    trainer = train.main([cfg, "--work_dir", work, "--epochs", "1"] + args)
    assert trainer.step == 1
    assert os.path.exists(os.path.join(work, "checkpoints", "epoch_1.pth"))
    log = open(os.path.join(work, "train.log")).read()
    assert "dataset: 2 frames" in log


@pytest.mark.parametrize("case", ["val_workflow", "db_sampler", "torch_init"])
def test_options_that_were_refused_now_run(labeled, case):
    """The options the port refused before its evaluation, GT-AUG and det3d
    loader slices: a workflow with a val phase (without --no_validate)
    returns the kitti-style metrics after the last epoch; a GT-AUG database
    that exists is built and pasted from, under --budget the subset's
    database; ``--torch_init`` starts from a converted det3d checkpoint."""
    root, info = labeled
    work = str(root / f"work_ran_{case}")
    if case == "torch_init":
        from dal3d_tpu_torch.models.builder import build_detector
        from dal3d_tpu_torch.models.convert_second import (save_raw_state_dict_npz,
                                                           to_det3d_state_dict)
        from dal3d_tpu_torch.utils.config import Config

        cfg = _write_cfg(root / f"cfg_ran_{case}.py", info, work)
        npz = str(root / "det3d.npz")
        src = build_detector(Config.fromfile(cfg), device="cpu", seed=4).model
        save_raw_state_dict_npz(to_det3d_state_dict(src.state_dict()), npz)
        tr = train.main([cfg, "--work_dir", work, "--epochs", "1", "--cpu", "--seed", "0",
                         "--no_validate", "--torch_init", npz])
        log = open(os.path.join(work, "train.log")).read()
        assert f"warm-started from converted torch checkpoint {npz}" in log
        # a few AdamW steps (lr <= 2e-3) moved the weights from the
        # checkpoint's, far nearer to them than to the seed-0 model's
        k = "neck.blocks.1.1.weight"
        ran = tr.bundle.model.state_dict()[k]
        seed0 = build_detector(Config.fromfile(cfg), device="cpu", seed=0).model.state_dict()[k]
        assert float((ran - src.state_dict()[k]).abs().mean()) < 0.2 * float(
            (ran - seed0).abs().mean())
    elif case == "val_workflow":
        cfg = _write_cfg(root / f"cfg_ran_{case}.py", info, work)
        tr = train.main([cfg, "--work_dir", work, "--epochs", "1", "--cpu", "--seed", "0"])
        log = open(os.path.join(work, "train.log")).read()
        val = re.findall(r"val epoch 1: (\{.*\})", log)
        assert len(val) == 1
        result = ast.literal_eval(val[0])
        assert set(result["kitti_style"]) == {"mAP_bev", "mAP_3d"}
        assert os.path.exists(os.path.join(work, "results_nusc.json"))
    else:
        sub = info.replace(".pkl", "_2.pkl")
        dump([load(info)[i] for i in (3, 0, 1, 2)], sub)
        db = create_groundtruth_database(str(root), sub, nsweeps=10, suffix="2")
        full_db = db.replace("_2.pkl", ".pkl")  # the config names the full database
        prep = dict(db_sampler=dict(type="GT-AUG", enable=False, db_info_path=full_db,
                                    sample_groups=[dict(car=4), dict(pedestrian=4)],
                                    db_prep_steps=[], rate=1.0))
        cfg = _write_cfg(root / f"cfg_ran_{case}.py", info, work, prep=prep)
        with open(cfg, "a") as f:  # the database's paths are relative to the data root
            f.write(f"data['train']['root_path'] = {str(root)!r}\n")
        tr = train.main([cfg, "--work_dir", work, "--epochs", "1", "--cpu", "--seed", "0",
                         "--no_validate", "--budget", "2"])
        log = open(os.path.join(work, "train.log")).read()
        assert f"training on {sub}" in log and f"GT-AUG database {db}" in log
        assert not os.path.exists(full_db)  # only the subset's database exists
    assert tr.epoch == 1 and tr.step >= 2
    assert os.path.exists(os.path.join(work, "checkpoints", "epoch_1.pth"))


def test_log_buffer_averages_the_last_n():
    buf = LogBuffer()
    for v in (1.0, 2.0, 6.0):
        buf.update({"loss": torch.tensor(v), "time": v})
    assert buf.average() == {"loss": 3.0, "time": 3.0}
    assert buf.average(2) == {"loss": 4.0, "time": 4.0}
    buf.clear()
    assert buf.average() == {}
