"""Two active-learning rounds through the PyTorch port's CLIs on the CPU
(``--cpu``: plain versions of the kernels), the port's twin of
tests/test_al_loop_e2e.py and of chip_smoke.py's AL-loop phase:

  create_data synthetic_data_prep                  (dataset + GT database)
  active_select            -> buffer init {"0": []}
  active_select --force_random                     (round 1)
  create_data nuscenes_data_prep --suffix B1       (GT database of the subset)
  train --budget B1                                (1 epoch, GT-AUG on, val)
  dist_test --checkpoint --out                     (eval metrics)
  active_select --checkpoint                       (round 2: FeatureSelector)

Each CLI runs as ``python -m dal3d_tpu_torch.tools.<name>`` in its own
process. The config is the production base (configs/_cbgs_base.py: its
GT-AUG sampler, its workflow with a val phase) cut to a 12.8 m grid, on a
synthetic set whose infos and GT database carry the same 10-sweep names.
Asserted: the buffer JSON accumulates two cumulative budgets, each round's
subset pkl matches the buffer, the suffixed GT database holds only the
subset's objects, training read the suffixed infos and database and ran its
val phase, and evaluation returned metrics."""
import ast
import json
import os
import pickle
import re
import subprocess
import sys

import pytest

from torch_port_utils import small_cfg

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(ws, tool, *argv, timeout=900):
    env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", f"dal3d_tpu_torch.tools.{tool}"] + list(argv),
                         cwd=ws, env=env, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, (
        f"{tool} {argv} failed rc={out.returncode}\n--- stdout ---\n{out.stdout[-3000:]}"
        f"\n--- stderr ---\n{out.stderr[-3000:]}")
    return out


def write_loop_config(path, root, buffer_file, work_dir):
    """The production base with the tiny grid of torch_port_utils.small_cfg,
    pointed at the synthetic set under ``root``."""
    small = small_cfg("float32")
    small["voxel_generator"].update(max_voxel_num=1500, bf16=False)
    lines = [f"import copy, sys\nsys.path.insert(0, {os.path.join(REPO, 'configs')!r})\n"
             "from _cbgs_base import *  # noqa: F401,F403\n",
             "data = copy.deepcopy(data)  # the base module is shared by every load\n"]
    lines += [f"{k} = {v!r}\n" for k, v in small.items()]
    info = os.path.join(root, "infos_{}_10sweeps_withvelo.pkl")
    lines += [
        f"data['train'].update(root_path={root!r}, info_path={info.format('train')!r})\n",
        f"data['val'].update(root_path={root!r}, info_path={info.format('val')!r})\n",
        "data['train']['pipeline'][2]['cfg']['db_sampler']['db_info_path'] = "
        f"{os.path.join(root, 'dbinfos_train_10sweeps_withvelo.pkl')!r}\n",
        "max_points = 40000\ntotal_epochs = 1\nworkflow = [('train', 1), ('val', 1)]\n",
        "log_config = dict(interval=1)\n",
        f"work_dir = {work_dir!r}\n",
        f"selector = dict(type='FeatureSelector', budget=1, buffer_file={buffer_file!r}, "
        f"infos_origin={info.format('train')!r}, distance_type='l2', streaming=False)\n",
    ]
    with open(path, "w") as f:
        f.writelines(lines)


def test_two_round_al_loop_through_the_port_clis(tmp_path):
    ws = str(tmp_path)
    root = os.path.join(ws, "data", "synthetic")
    buffer_file = os.path.join(ws, "buffer.json")
    work1 = os.path.join(ws, "work", "round1")
    cfg = os.path.join(ws, "loop_cfg.py")
    write_loop_config(cfg, root, buffer_file, work1)

    _run(ws, "create_data", "synthetic_data_prep", "--root_path", root, "--n_frames", "8",
         "--n_logs", "2", "--range_xy", "6.0")
    infos_origin = os.path.join(root, "infos_train_10sweeps_withvelo.pkl")
    assert os.path.exists(os.path.join(root, "dbinfos_train_10sweeps_withvelo.pkl"))

    _run(ws, "active_select", cfg, "--cpu")
    assert json.load(open(buffer_file)) == {"0": []}

    _run(ws, "active_select", cfg, "--cpu", "--force_random")
    buf = json.load(open(buffer_file))
    rounds = sorted(int(k) for k in buf)
    assert len(rounds) == 2 and rounds[0] == 0
    b1 = rounds[1]
    assert len(buf[str(b1)]) >= 1
    origin = pickle.load(open(infos_origin, "rb"))
    sub1 = pickle.load(open(infos_origin.replace(".pkl", f"_{b1}.pkl"), "rb"))
    assert [i["token"] for i in sub1] == [origin[i]["token"] for i in buf[str(b1)]]

    _run(ws, "create_data", "nuscenes_data_prep", "--root_path", root, "--suffix", str(b1))
    db1 = os.path.join(root, f"dbinfos_train_10sweeps_withvelo_{b1}.pkl")
    dbinfos = pickle.load(open(db1, "rb"))
    tokens = {i["token"] for i in sub1}
    n_sub = sum(len(i["gt_names"]) for i in sub1)
    n_db = 0
    for cls_infos in dbinfos.values():
        for di in cls_infos:
            assert di["image_idx"] < len(sub1), "GT database leaked unselected frames"
            assert sub1[di["image_idx"]]["token"] in tokens
            n_db += 1
    assert n_db == n_sub

    _run(ws, "train", cfg, "--cpu", "--budget", str(b1), "--work_dir", work1, "--seed", "0")
    log = open(os.path.join(work1, "train.log")).read()
    assert f"training on {infos_origin.replace('.pkl', f'_{b1}.pkl')}" in log
    assert f"GT-AUG database {db1}" in log
    val = re.findall(r"val epoch 1: (\{.*\})", log)
    assert len(val) == 1 and "mAP_bev" in ast.literal_eval(val[0])["kitti_style"]
    assert os.path.exists(os.path.join(work1, "checkpoints", "epoch_1.pth"))

    dets = os.path.join(ws, "dets.pkl")
    _run(ws, "dist_test", cfg, "--cpu", "--checkpoint", work1, "--work_dir", work1,
         "--out", dets)
    detections = pickle.load(open(dets, "rb"))
    val_infos = pickle.load(open(os.path.join(root, "infos_val_10sweeps_withvelo.pkl"), "rb"))
    assert set(detections) == {i["token"] for i in val_infos}
    assert os.path.exists(os.path.join(work1, "results_nusc.json"))
    elog = open(os.path.join(work1, "test.log")).read()
    assert "evaluation:" in elog and "mAP_3d" in elog

    _run(ws, "active_select", cfg, "--cpu", "--checkpoint", work1)
    buf2 = json.load(open(buffer_file))
    rounds2 = sorted(int(k) for k in buf2)
    assert len(rounds2) == 3, f"two cumulative budgets expected, got {rounds2}"
    b2 = rounds2[2]
    assert set(buf2[str(b1)]) <= set(buf2[str(b2)])
    assert len(set(buf2[str(b2)])) == len(buf2[str(b2)]) > len(buf2[str(b1)])
    sub2 = pickle.load(open(infos_origin.replace(".pkl", f"_{b2}.pkl"), "rb"))
    assert [i["token"] for i in sub2] == [origin[i]["token"] for i in buf2[str(b2)]]
