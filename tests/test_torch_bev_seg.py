"""The port's map-segmentation targets (``data/pipelines/bev_seg.py``,
``LoadBEVSegmentation`` in ``build_pipeline`` and ``ReformatFixedShape``'s
``gt_masks_bev``) against the JAX package's on the CPU. No JAX compile:
both are numpy.

Required bit-equal: the masks [C, Wc, Hc] of each frame of a synthetic set
through a train-mode pipeline whose ``Preprocess`` draws flip, rotation and
scale from numpy's seeded generator (a canvas with other x and y extents, so
that a swapped axis shows); the same with ``map_location`` and a dataset
root set and no devkit installed (the synthetic fallback); the example key
[Hc, Wc, C] f32 after ``ReformatFixedShape`` and the loader's stacked batch
in val mode. A devkit whose map files fail to load is logged as a warning
and falls back to the synthetic masks, in both packages."""
import logging

import numpy as np
import pytest

from dal3d_tpu.data import DataLoader as JaxLoader
from dal3d_tpu.data import NuScenesDataset as JaxDataset
from dal3d_tpu.data.datasets.nuscenes import build_pipeline as jax_build
from dal3d_tpu.data.pipelines import bev_seg as jbs
from dal3d_tpu_torch.data import DataLoader, NuScenesDataset, build_pipeline
from dal3d_tpu_torch.data.datasets.synthetic import make_synthetic_nuscenes
from dal3d_tpu_torch.data.pipelines import bev_seg as tbs
from dal3d_tpu_torch.utils.fileio import load

CLASSES = ["car", "pedestrian", "traffic_cone"]
TASKS = [dict(num_class=3, class_names=CLASSES)]
SEG = dict(type="LoadBEVSegmentation", xbound=(-8.0, 8.0, 0.5), ybound=(-6.0, 6.0, 0.4))


def pipeline(mode: str, **seg):
    pre = (dict(mode="train", shuffle_points=False, global_rot_noise=[-0.4, 0.4],
                global_scale_noise=[0.9, 1.1], db_sampler=None, class_names=CLASSES)
           if mode == "train" else dict(mode="val", shuffle_points=False))
    return [dict(type="LoadPointCloudFromFile", dataset="NuScenesDataset"),
            dict(type="LoadPointCloudAnnotations", with_bbox=True),
            dict(type="Preprocess", cfg=pre),
            dict(SEG, **seg),
            dict(type="ReformatFixedShape", max_gt=16)]


@pytest.fixture(scope="module")
def info_path(tmp_path_factory):
    root = tmp_path_factory.mktemp("bev_seg")
    return make_synthetic_nuscenes(str(root), n_frames=4, n_logs=2, points_per_frame=2000,
                                   range_xy=7.0, seed=3, classes=CLASSES)


def _run(stages, info: dict, mode: str, seed: int):
    np.random.seed(seed)  # Preprocess draws from numpy's global generator
    res = {"lidar": {"type": "lidar", "points": None, "nsweeps": 1},
           "metadata": {"image_prefix": "", "num_point_features": 5, "token": info["token"]},
           "mode": mode}
    masks = None
    for st in stages:
        res, info = st(res, info)
        if type(st).__name__ == "LoadBEVSegmentation":
            masks = res["gt_masks_bev"]
    return masks, res


@pytest.mark.parametrize("map_location", [None, "boston-seaport"])
def test_masks_bit_equal_to_jax(info_path, tmp_path, map_location):
    seg = dict(dataset_root=str(tmp_path)) if map_location else {}
    ours = build_pipeline(pipeline("train", **seg), tasks=TASKS, max_points=4096)
    theirs = jax_build(pipeline("train", **seg), tasks=TASKS, max_points=4096)
    assert type(ours[3]).__name__ == "LoadBEVSegmentation" and ours[3].canvas == (32, 30)
    filled = []
    for fi, info in enumerate(load(info_path)):
        info = dict(info, map_location=map_location) if map_location else dict(info)
        mo, ro = _run(ours, dict(info), "train", fi)
        mt, rt = _run(theirs, dict(info), "train", fi)
        assert mo.dtype == mt.dtype == np.float32 and mo.shape == (6, 32, 30)
        assert np.array_equal(mo, mt), fi
        filled.append(mo.mean())
        ex, ext = ro["gt_masks_bev"], rt["gt_masks_bev"]
        assert ex.dtype == ext.dtype == np.float32 and ex.shape == (30, 32, 6)
        assert np.array_equal(ex, ext) and np.array_equal(ex, mo.transpose(2, 1, 0))
    assert 0 < max(filled) < 1  # the frames see road and off-road cells


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_corrupt_map_falls_back_with_a_warning(info_path, tmp_path, monkeypatch):
    info = dict(load(info_path)[0], map_location="boston-seaport")
    res = {"lidar": {"aug_matrix": np.eye(3, dtype=np.float32)}}
    outs = []
    # a handler on the package's logger itself: the trainers' root logger
    # set up by other tests in the same process stops propagation
    records = _Records()
    logging.getLogger("dal3d").addHandler(records)
    try:
        for mod in (tbs, jbs):
            def broken(self, info, l2g):
                raise OSError("map file unreadable")

            monkeypatch.setattr(mod.LoadBEVSegmentation, "_devkit_masks", broken)
            stage = mod.LoadBEVSegmentation(SEG["xbound"], SEG["ybound"],
                                            dataset_root=str(tmp_path))
            records.messages.clear()
            out, _ = stage(dict(res), info)
            assert any("using synthetic masks" in m for m in records.messages), mod
            outs.append(out["gt_masks_bev"])
    finally:
        logging.getLogger("dal3d").removeHandler(records)
    assert np.array_equal(outs[0], outs[1])
    assert np.array_equal(tbs.synthetic_map_masks(np.zeros((2, 2)), ["walkway"]),
                          jbs.synthetic_map_masks(np.zeros((2, 2)), ["walkway"]))
    assert tbs.CLASS2LAYERS == jbs.CLASS2LAYERS


def test_val_batches_equal_jax(info_path):
    ds = NuScenesDataset(info_path=info_path, nsweeps=1, class_names=CLASSES, test_mode=True,
                         pipeline=pipeline("val"), tasks=TASKS, max_points=4096)
    jds = JaxDataset(info_path=info_path, nsweeps=1, class_names=CLASSES, test_mode=True,
                     pipeline=pipeline("val"), tasks=TASKS, max_points=4096)
    # the stage leaves the points alone: the val-mode read cap stays on in both
    assert ds.pipeline[0].max_points == jds.pipeline[0].max_points == 4096
    ours = list(DataLoader(ds, 2, shuffle=False, drop_last=False, prefetch=0))
    theirs = list(JaxLoader(jds, 2, shuffle=False, drop_last=False, prefetch=0))
    assert len(ours) == len(theirs) == 2
    for bo, bt in zip(ours, theirs):
        assert bo["gt_masks_bev"].shape == (2, 30, 32, 6)
        assert np.array_equal(bo["gt_masks_bev"], np.asarray(bt["gt_masks_bev"]))
        assert np.array_equal(bo["points"], np.asarray(bt["points"]))
