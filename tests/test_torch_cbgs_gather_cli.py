"""The three synthetic CBGS configs through the port's CLIs as written, on
the CPU: ``configs/cbgs_synthetic.py``, ``cbgs_entropy_synthetic.py`` and
``cbgs_partial_synthetic.py`` name no backbone engine, so they build the
gather engine (JAX's default) with their ``voxel_caps``.

In a working directory holding a synthetic set written by ``create_data
synthetic_data_prep`` at the configs' own relative paths:
- ``train`` on cbgs_synthetic.py: its workflow (two train epochs, then the
  val phase), checkpoints, no brick-capacity report (the gather engine has
  none, as in JAX), a finite loss;
- ``active_select`` on cbgs_entropy_synthetic.py (EntropySelector) with that
  checkpoint: the first call writes the empty buffer, the second picks
  frames of the pool under the config's cost budget and writes their
  subset infos;
- ``train`` on cbgs_partial_synthetic.py (ActiveTrainer, one epoch): the
  seed buffer ``partial_01``, the checkpoint and ``estimator.npz`` (the
  estimator's flat names and shapes), each consistent with the others."""
import json
import os

import numpy as np
import pytest
import torch

from dal3d_tpu_torch.models.convert_flax import estimator_to_flat
from dal3d_tpu_torch.models.detectors.estimator import Estimator
from dal3d_tpu_torch.runtime.checkpoint import latest_epoch, load_checkpoint
from dal3d_tpu_torch.tools import active_select, create_data, train
from dal3d_tpu_torch.utils.config import Config
from dal3d_tpu_torch.utils.fileio import load

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_synthetic_cbgs_configs_as_written(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    create_data.main(["synthetic_data_prep", "--root_path", "data/synthetic", "--n_frames", "4",
                      "--n_logs", "2", "--range_xy", "7"])
    base = os.path.join(CONFIGS, "cbgs_synthetic.py")
    tr = train.main([base, "--cpu", "--seed", "0"])
    model = tr.bundle.model
    assert model.backbone.impl == "gather" and model.backbone.caps == (8000, 4000, 2000, 2000)
    work = "work_dirs/cbgs_synthetic"
    assert latest_epoch(work) == 2
    log = open(os.path.join(work, "train.log")).read()
    assert "brick capacities" not in log and "val epoch 2" in log
    _, meta = load_checkpoint(work, model)
    assert meta["epoch"] == 2

    entropy = os.path.join(CONFIGS, "cbgs_entropy_synthetic.py")
    buffer_file = Config.fromfile(entropy)["selector"]["buffer_file"]
    active_select.main([entropy, "--cpu"])  # the first round: the empty buffer
    assert load(buffer_file) == {"0": []}
    active_select.main([entropy, "--cpu", "--checkpoint", work])
    picked = load(buffer_file)["3"]  # pool indices under the cost budget 3
    infos = load("data/synthetic/infos_train_10sweeps_withvelo.pkl")
    assert 0 < len(picked) == len(set(picked)) and set(picked) <= set(range(len(infos)))
    subset = load("data/synthetic/infos_train_10sweeps_withvelo_3.pkl")
    assert [i["token"] for i in subset] == [infos[k]["token"] for k in picked]

    partial = os.path.join(CONFIGS, "cbgs_partial_synthetic.py")
    pt = train.main([partial, "--cpu", "--seed", "0", "--epochs", "1", "--no_validate"])
    assert pt.bundle.model.backbone.impl == "gather"
    seed = json.load(open("data/buffers/partial_synth.json"))
    assert list(seed) == ["partial_01"] and len(seed["partial_01"]) == 2  # 0.5 of 4 frames
    assert set(seed["partial_01"]) <= set(range(len(infos)))  # pool indices
    pwork = "work_dirs/cbgs_partial_synth"
    assert latest_epoch(pwork) == 1 and pt.estimator_optimizer.count == pt.step > 0
    est = dict(np.load(os.path.join(pwork, "estimator.npz")))
    want = estimator_to_flat(Estimator(max_pts=64, hidden=(32, 64)))
    assert {k: v.shape for k, v in est.items()} == {k: v.shape for k, v in want.items()}
    assert all(np.isfinite(v).all() for v in est.values())
    plog = open(os.path.join(pwork, "train.log")).read()
    assert "ActiveTrainer" in plog and "brick capacities" not in plog
