"""The partial-label dataset and the partial-label round through the port's
CLIs, on the CPU.

- ``NuScenesPartialDataset`` against the JAX package's on the same infos:
  ``start`` (a fresh draw), a resume (an existing buffer is read, not
  redrawn), a named flag, no buffer, ``faithful_start`` and
  ``label_fraction`` give the same frame list after the CBGS resample, the
  same kept boxes and a byte-equal buffer JSON;
- ``data/dataset_factory.py``: the names JAX maps, KITTI and Lyft refused
  with their ROADMAP item, unknown names a ``KeyError``;
- ``python -m dal3d_tpu_torch.tools.train`` on ``configs/cbgs_partial_synthetic.py``
  over a set made by the port's ``create_data``: it writes the seed buffer
  ``partial_01``, the checkpoint and ``estimator.npz`` (JAX's names and
  shapes); ``active_select`` (``EntropySelector``, the production partial
  config's selector, with ``exclude_buffer``) picks no frame of
  ``partial_01`` (the next round's ``train`` on the picks runs in
  ``chip_smoke.py`` phase 17). The synthetic config's backbone is the
  gather engine, which the port does not run (ROADMAP A9.d): the test's
  config imports it and switches the backbone to the banded engine, nothing
  else. Without ``--cpu`` on a box with no GPU the CLI raises."""
import os
import re

import jax
import numpy as np
import pytest
import torch

from dal3d_tpu.data.datasets.nuscenes_partial import NuScenesPartialDataset as JaxPartial
from dal3d_tpu_torch.data.dataset_factory import build_dataset, get_dataset_cls
from dal3d_tpu_torch.data.datasets.nuscenes import NuScenesDataset
from dal3d_tpu_torch.data.datasets.nuscenes_partial import NuScenesPartialDataset
from dal3d_tpu_torch.data.datasets.synthetic import DEFAULT_CLASSES, make_synthetic_nuscenes
from dal3d_tpu_torch.tools import active_select, create_data, train
from dal3d_tpu_torch.utils.fileio import dump, load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANNOS = [dict(type="LoadPointCloudAnnotations", with_bbox=True)]


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    root = tmp_path_factory.mktemp("partial_pool")
    info = make_synthetic_nuscenes(str(root), n_frames=20, n_logs=2, points_per_frame=200,
                                   max_boxes=8, seed=3)
    return root, info


CASES = {
    "start": dict(active_flag="start", sample_ratio=0.3, partial_seed=5),
    "resume": dict(active_flag="start", sample_ratio=0.3, partial_seed=5),
    "flag": dict(active_flag="12"),
    "no_buffer": dict(active_flag="start", sample_ratio=0.3, buffer=""),
    "faithful_start": dict(active_flag="start", sample_ratio=0.4, faithful_start=True,
                           partial_seed=2),
    "label_fraction": dict(active_flag="start", sample_ratio=0.5, label_fraction=0.4,
                           partial_seed=7),
}


@pytest.mark.parametrize("case", list(CASES))
def test_partial_dataset_matches_jax(pool, tmp_path, case):
    root, info = pool
    kw = {k: v for k, v in CASES[case].items() if k != "buffer"}
    frames, buffers, boxes = {}, {}, {}
    for name, cls in (("jax", JaxPartial), ("port", NuScenesPartialDataset)):
        d = tmp_path / name
        d.mkdir()
        buf = CASES[case].get("buffer", str(d / "partial.json"))
        if case == "resume":  # a recorded seed set is read, never redrawn
            dump({"partial_01": [4, 17, 0]}, buf, indent=4)
        if case == "flag":
            dump({"0": [], "12": [3, 5, 8, 13]}, buf)
        np.random.seed(11)  # the CBGS resample draws from numpy's global generator
        ds = cls(info_path=info, root_path=str(root), nsweeps=10, class_names=DEFAULT_CLASSES,
                 pipeline=[dict(s) for s in ANNOS], active_buffer=buf or "", **kw)
        frames[name] = [i["token"] for i in ds.infos]
        buffers[name] = open(buf, "rb").read() if buf and os.path.exists(buf) else None
        boxes[name] = [ds.get_sensor_data(i)["lidar"]["annotations"]["boxes"]
                       for i in range(len(ds))]
    assert frames["port"] == frames["jax"] and len(frames["port"]) > 0
    assert buffers["port"] == buffers["jax"]
    assert len(boxes["port"]) == len(boxes["jax"])
    for a, b in zip(boxes["port"], boxes["jax"]):
        np.testing.assert_array_equal(a, b)
    infos = load(info)
    if case in ("start", "faithful_start", "label_fraction"):
        ids = load(str(tmp_path / "port" / "partial.json"))["partial_01"]
        assert len(ids) == int(len(infos) * kw["sample_ratio"])
        if case == "faithful_start":  # the reference's quirk: the first ids permuted
            assert sorted(ids) == list(range(len(ids)))
        assert set(frames["port"]) <= {infos[i]["token"] for i in ids}
    if case == "resume":
        assert load(str(tmp_path / "port" / "partial.json")) == {"partial_01": [4, 17, 0]}
    if case == "no_buffer":  # the whole pool, resampled
        assert len(set(frames["port"])) > int(0.3 * len(infos))
    if case == "label_fraction":  # boxes dropped, never a frame's last one
        full = sum(len(i["gt_boxes"]) for i in infos)
        assert 0 < sum(len(b) for b in boxes["port"]) and all(len(b) for b in boxes["port"])
        assert full > 0


def test_dataset_factory(pool):
    root, info = pool
    for name in ("NUSC", "NuScenesDataset"):
        assert get_dataset_cls(name) is NuScenesDataset
    for name in ("NUSC_PART", "NuScenesPartialDataset"):
        assert get_dataset_cls(name) is NuScenesPartialDataset
    for name in ("KITTI", "KittiDataset", "LYFT", "LyftDataset"):
        with pytest.raises(NotImplementedError, match="ROADMAP A9.g"):
            get_dataset_cls(name)
    with pytest.raises(KeyError, match="unknown dataset_type"):
        get_dataset_cls("Waymo")
    ds = build_dataset(dict(type="NUSC_PART", info_path=info, ann_file=info,
                            class_names=DEFAULT_CLASSES, active_flag="start",
                            active_buffer="not_a_json"), test_mode=True)
    assert isinstance(ds, NuScenesPartialDataset) and len(ds) == 20


def _write_partial_cfg(ws, **over):
    """configs/cbgs_partial_synthetic.py with the banded backbone (the port's
    engine) at brick caps for its 128 x 128 grid, one epoch, no val, and the
    production partial config's EntropySelector."""
    lines = [
        "import copy, sys\n",
        f"sys.path.insert(0, {os.path.join(REPO, 'configs')!r})\n",
        "from cbgs_partial_synthetic import *  # noqa: F401,F403\n",
        "model = copy.deepcopy(model)\n",
        "model['backbone'].update(impl='banded', dtype='float32', brick_widths=(8, 8, 8, 4, 4),"
        " banded_caps=(6144, 3072, 1536, 768, 768))\n",
        "total_epochs = 1\nworkflow = [('train', 1)]\n",
        "selector = dict(type='EntropySelector', budget=2, buffer_file='data/buffers/partial.json',"
        " infos_origin=train_anno, exclude_buffer=active_buffer)\n",
    ] + [f"{k} = {v!r}\n" for k, v in over.items()]
    path = os.path.join(ws, f"cfg_{len(over)}.py")
    with open(path, "w") as f:
        f.writelines(lines)
    return path


def test_partial_round_through_the_clis(tmp_path, monkeypatch):
    from dal3d_tpu.models.convert_second import flatten_tree
    from dal3d_tpu.models.detectors.estimator import Estimator as JaxEstimator

    monkeypatch.chdir(tmp_path)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        create_data.main(["synthetic_data_prep", "--root_path", "data/synthetic",
                          "--n_frames", "4", "--n_logs", "2", "--range_xy", "7"])
        cfg = _write_partial_cfg(str(tmp_path))
        tr = train.main([cfg, "--cpu", "--seed", "0"])
        seed = load("data/buffers/partial_synth.json")
        assert list(seed) == ["partial_01"] and len(seed["partial_01"]) == 2  # 0.5 of 4
        assert open("data/buffers/partial_synth.json").read().startswith('{\n    "partial_01"')
        assert os.path.exists("work_dirs/cbgs_partial_synth/checkpoints/epoch_1.pth")
        assert tr.estimator_optimizer.count == tr.step > 0
        est = dict(np.load("work_dirs/cbgs_partial_synth/estimator.npz"))
        pts = np.zeros((1, 128, 5), np.float32)
        want = flatten_tree(jax.device_get(JaxEstimator(max_pts=64, hidden=(32, 64)).init(
            jax.random.PRNGKey(0), pts, np.ones((1, 128), bool),
            np.ones((1, 4, 9), np.float32))["params"]))
        assert {k: v.shape for k, v in est.items()} == {k: v.shape for k, v in want.items()}
        log = open("work_dirs/cbgs_partial_synth/train.log").read()
        assert "ActiveTrainer" in log and "brick capacities" in log
        est_loss = re.findall(r"\[active\] epoch 1: loss [0-9.]+, estimator_loss ([0-9.na]+)", log)
        assert len(est_loss) == 1 and np.isfinite(float(est_loss[0]))
        assert "saved estimator params" in log

        # selection on the trained checkpoint, never re-picking partial_01
        active_select.main([cfg, "--cpu"])  # first round: the empty buffer
        active_select.main([cfg, "--cpu", "--checkpoint", "work_dirs/cbgs_partial_synth"])
        picked = load("data/buffers/partial.json")["2"]
        assert len(picked) == 2 and not set(picked) & set(seed["partial_01"])

    finally:
        torch.set_num_threads(n)


def test_cli_without_cpu_raises_on_a_box_without_gpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _write_partial_cfg(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main([cfg])
    assert not os.path.exists(tmp_path / "work_dirs")
