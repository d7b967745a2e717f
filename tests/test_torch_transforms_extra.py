"""The extra pipeline stages of the PyTorch port (``data/pipelines/
transforms_extra.py``) against the JAX package's, on the CPU: each of the 15
stage names, built from the same config by each package's
``build_pipeline``, gives JAX's output bit for bit on the same input and the
same numpy seed, over three calls in a row (so the random streams advance
alike), on the loader's annotation keys and on ``Preprocess``'s; ``ObjectPaste``
pastes from a small GT database; ``ImagePad`` keeps the val-mode sweep cap
and ``PointShuffle`` drops it, in both packages."""
import copy

import numpy as np
import pytest

from dal3d_tpu.data.datasets.nuscenes import build_pipeline as jbuild
from dal3d_tpu_torch.data.datasets.nuscenes import EXTRA_STAGES, build_pipeline
from dal3d_tpu_torch.utils.fileio import dump

RANGE = [-10.0, -10.0, -4.0, 10.0, 10.0, 2.0]
NAMES = ["car", "pedestrian", "truck", "car", "barrier", "car"]


def _res(seed: int, keys: str) -> dict:
    """A train-mode sample: 10-sweep points [N, 5] (time offsets in column
    4), boxes under the loader's or Preprocess's keys, two camera images and
    BEV masks."""
    rng = np.random.RandomState(seed)
    n = 1200
    pts = np.zeros((n, 5), np.float32)
    pts[:, :2] = rng.uniform(-12, 12, (n, 2))
    pts[:, 2] = rng.uniform(-4.5, 2.5, n)
    pts[:, 3] = rng.uniform(0, 1, n)
    pts[:, 4] = rng.choice([0.0, 0.05, 0.1, 0.15], n)
    boxes = np.zeros((len(NAMES), 9), np.float32)
    boxes[:, :2] = rng.uniform(-11, 11, (len(NAMES), 2))
    boxes[:, 2] = -1.5
    boxes[:, 3:6] = rng.uniform(0.5, 4.0, (len(NAMES), 3))
    boxes[:, 6:8] = rng.normal(0, 1, (len(NAMES), 2))
    boxes[:, 8] = rng.uniform(-4, 4, len(NAMES))
    pts[:300, :2] = boxes[rng.randint(len(NAMES), size=300), :2] + rng.normal(0, 0.5, (300, 2))
    if keys == "loader":
        anno = {"boxes": boxes, "names": np.asarray(NAMES),
                "tokens": np.asarray([f"t{i}" for i in range(len(NAMES))]),
                "velocities": rng.normal(0, 1, (len(NAMES), 3)).astype(np.float32)}
    else:
        anno = {"gt_boxes": boxes, "gt_names": np.asarray(NAMES),
                "gt_classes": np.arange(1, len(NAMES) + 1, dtype=np.int32)}
    images = [rng.uniform(0, 255, (37, 50, 3)).astype(np.float32) for _ in range(2)]
    return {"mode": "train", "metadata": {"image_prefix": ""},
            "lidar": {"points": pts, "annotations": anno},
            "camera": {"np_images": images},
            "gt_masks_bev": rng.rand(3, 16, 12) > 0.5}


def _same(a, b, where="res"):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), where
    else:
        assert type(a) is type(b) and a == b, where


@pytest.fixture(scope="module")
def gt_db(tmp_path_factory):
    """A GT database with inline points: 12 cars and 8 pedestrians."""
    rng = np.random.RandomState(7)
    infos = {}
    for name, n in (("car", 12), ("pedestrian", 8)):
        infos[name] = []
        for i in range(n):
            box = np.array([*rng.uniform(-9, 9, 2), -1.5, *rng.uniform(0.6, 4.5, 3), 0.0, 0.0,
                            rng.uniform(-3, 3)], np.float32)
            pts = rng.normal(0, 0.4, (rng.randint(5, 30), 5)).astype(np.float32)
            infos[name].append(dict(name=name, box3d_lidar=box, points=pts,
                                    num_points_in_gt=len(pts), difficulty=0, image_idx=i))
    path = str(tmp_path_factory.mktemp("gt_db") / "dbinfos.pkl")
    dump(infos, path)
    return path


def _stage_cfgs(db_path):
    """One config a stage name; ``True`` marks the stages that draw from a
    ``rng`` (each package gets its own RandomState of the same seed)."""
    vox = dict(voxel_size=[0.5, 0.5, 0.5], point_cloud_range=RANGE, max_num_points=3,
               max_voxels=400)
    return {
        "FrameDropout": (dict(prob=0.5, time_dim=-1), True),
        "PointSample": (dict(num_points=700, sample_range=6.0), True),
        "BackgroundPointsFilter": (dict(bbox_enlarge_range=(0.5, 0.4, 0.3)), False),
        "VoxelBasedPointSampler": (dict(cur_sweep_cfg=vox, prev_sweep_cfg=dict(vox),
                                        time_dim=4), True),
        "ImagePad": (dict(size_divisor=32), False),
        "ImageDistort": (dict(), True),
        "PhotoMetricDistortionMultiViewImage": (dict(hue_delta=30.0), True),
        "GlobalRotScaleTrans": (dict(resize_lim=(0.9, 1.1), rot_lim=(-0.8, 0.8),
                                     trans_lim=0.5), True),
        "RandomFlip3D": (dict(probability=0.5), True),
        "ObjectPaste": (dict(db_sampler=dict(db_info_path=db_path,
                                             sample_groups=[dict(car=6), dict(pedestrian=4)],
                                             rate=1.0)), False),
        "ObjectNoise": (dict(translation_std=(0.5, 0.5, 0.2), rot_range=(-0.3, 0.3),
                             num_try=20), True),
        "PointShuffle": (dict(), True),
        "ObjectRangeFilter": (dict(point_cloud_range=[-8.0, -8.0, -4.0, 8.0, 8.0, 2.0]), False),
        "PointsRangeFilter": (dict(point_cloud_range=RANGE), False),
        "ObjectNameFilter": (dict(classes=["car", "pedestrian"]), False),
    }


def test_every_stage_name_is_mapped():
    assert len(EXTRA_STAGES) == 15
    assert EXTRA_STAGES["PhotoMetricDistortionMultiViewImage"] == "ImageDistort"


@pytest.mark.parametrize("keys", ["loader", "preprocess"])
@pytest.mark.parametrize("name", sorted(EXTRA_STAGES))
def test_stage_is_bit_equal_to_jax(name, keys, gt_db):
    cfg, random = _stage_cfgs(gt_db)[name]
    outs, classes = [], []
    for build in (jbuild, build_pipeline):
        c = dict(cfg, type=name, **({"rng": np.random.RandomState(11)} if random else {}))
        np.random.seed(3)  # ObjectPaste's sampler draws from numpy's global generator
        (stage,) = build([copy.deepcopy(c)])
        classes.append(type(stage).__name__)
        if name == "BackgroundPointsFilter" and keys == "loader":
            with pytest.raises(KeyError):  # it reads Preprocess's gt_boxes alone, as JAX's
                stage(_res(0, keys), {})
            continue
        outs.append([stage(_res(seed, keys), {})[0] for seed in range(3)])
    assert classes[0] == classes[1]
    for want, got in zip(*outs):
        _same(want, got)
    if name == "ObjectPaste":  # objects were pasted
        key = "boxes" if keys == "loader" else "gt_boxes"
        assert max(len(r["lidar"]["annotations"][key]) for r in outs[1]) > len(NAMES)


def test_image_pad_keeps_the_val_sweep_cap():
    for stages, capped in (([dict(type="ImagePad", size_divisor=32)], True),
                           ([dict(type="PointShuffle")], False)):
        pipe = [dict(type="LoadPointCloudFromFile"), *stages, dict(type="ReformatFixedShape")]
        tasks = [dict(num_class=1, class_names=["car"])]
        for build in (jbuild, build_pipeline):
            load = build(copy.deepcopy(pipe), tasks=tasks, max_points=1234)[0]
            assert load.max_points == (1234 if capped else None)
