"""The port's camera pipeline (dal3d_tpu_torch/data/pipelines/camera.py, the
camera stages of build_pipeline, ReformatFixedShape's camera keys and the
synthetic writer's cameras) against the JAX package's on the CPU.

The pipeline calls PIL as the JAX package does (PIL is on the GPU machine
too), so every array is required bit-equal: the synthetic JPEG frames, each
stage's images and image-augmentation affines in train mode with seeded
RandomStates (resize, crop, flip, rotation; GridMask with its rotation),
the normalised images, the depth images rasterised from the lidar points
and the extrinsics with the lidar augmentation folded in, and the batches of
the whole dataset through the loader."""
import os

import numpy as np
import pytest

from dal3d_tpu.data import DataLoader as JaxLoader
from dal3d_tpu.data import NuScenesDataset as JaxDataset
from dal3d_tpu.data.datasets.nuscenes import build_pipeline as jax_build
from dal3d_tpu.data.datasets.synthetic import make_synthetic_nuscenes as jax_synth
from dal3d_tpu_torch.data import DataLoader, NuScenesDataset, build_pipeline
from dal3d_tpu_torch.data.datasets.synthetic import make_synthetic_nuscenes
from dal3d_tpu_torch.data.pipelines import camera as tcam
from dal3d_tpu_torch.utils.fileio import load

CLASSES = ["car", "pedestrian", "traffic_cone"]
TASKS = [dict(num_class=3, class_names=CLASSES)]
TRAIN_PRE = dict(mode="train", shuffle_points=False, global_rot_noise=[-0.4, 0.4],
                 global_scale_noise=[0.9, 1.1], db_sampler=None, class_names=CLASSES)


def pipeline(mode: str):
    """configs/bevfusion_cl.py's camera pipeline at 32 x 48 (GridMask on,
    with its rotation, so that every stage draws)."""
    pre = TRAIN_PRE if mode == "train" else dict(mode="val", shuffle_points=False)
    aug = (dict(resize_lim=(0.45, 0.55), bot_pct_lim=(0.0, 0.1), rot_lim=(-5.4, 5.4),
                rand_flip=True) if mode == "train" else dict(resize_lim=(0.5, 0.5)))
    return [dict(type="LoadPointCloudFromFile", dataset="NuScenesDataset"),
            dict(type="LoadPointCloudAnnotations", with_bbox=True),
            dict(type="LoadMultiViewImages"),
            dict(type="Preprocess", cfg=pre),
            dict(type="ImageAug3D", final_dim=(32, 48), **aug),
            dict(type="GridMask", prob=1.0, ratio=0.4, rotate=3),
            dict(type="ImageNormalize"),
            dict(type="ReformatCamera", final_dim=(32, 48)),
            dict(type="ReformatFixedShape", max_gt=16)]


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """The same seeded 4-frame camera set from both writers."""
    root = tmp_path_factory.mktemp("camera_frames")
    kw = dict(n_frames=4, n_logs=1, points_per_frame=3000, range_xy=7.0, seed=2,
              classes=CLASSES, with_camera=True, image_hw=(64, 96))
    info = make_synthetic_nuscenes(str(root / "port"), **kw)
    jinfo = jax_synth(str(root / "jax"), **kw)
    return info, jinfo


def test_synthetic_camera_frames_equal_jax(frames):
    info, jinfo = frames
    ours, theirs = load(info), load(jinfo)
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        assert list(a["cams"]) == list(b["cams"]) == list(tcam.DEFAULT_CAMS)
        for name in a["cams"]:
            ca, cb = a["cams"][name], b["cams"][name]
            for k in ("camera_intrinsics", "sensor2lidar_rotation", "sensor2lidar_translation"):
                assert np.array_equal(ca[k], cb[k]), k
            assert open(ca["data_path"], "rb").read() == open(cb["data_path"], "rb").read()
        assert np.array_equal(a["gt_boxes"], b["gt_boxes"])


def _stages(build, mode, seed):
    stages = build(pipeline(mode), tasks=TASKS, max_points=4096)
    for k, st in enumerate(stages):
        if hasattr(st, "rng"):  # ImageAug3D, GridMask: seeded, the same in both
            st.rng = np.random.RandomState(seed + k)
    return stages


def _arrays(res) -> dict:
    """The camera state after a stage, as numpy arrays."""
    cam = res["camera"]
    out = {k: np.asarray(cam[k]) for k in ("camera_intrinsics", "camera2lidar_rots",
                                           "camera2lidar_trans", "aug_rots", "aug_trans")}
    imgs = cam.get("np_images") or [np.asarray(i) for i in cam["pil_images"]]
    out["images"] = np.stack(imgs)
    out.update(cam.get("batch", {}))
    return out


def _run(stages, info: dict, mode: str, seed: int):
    """The stages over one frame as the dataset runs them (numpy's global
    generator seeded first: Preprocess draws from it); returns the camera
    state after each camera stage, and the last result."""
    np.random.seed(seed)
    res = {"lidar": {"type": "lidar", "points": None, "nsweeps": 1},
           "metadata": {"image_prefix": "", "num_point_features": 5, "token": info["token"]},
           "mode": mode}
    snaps = []
    for st in stages:
        res, info = st(res, info)
        if "camera" in res and type(st).__name__ != "ReformatFixedShape":
            snaps.append((type(st).__name__, _arrays(res)))
    return snaps, res


@pytest.mark.parametrize("mode", ["train", "val"])
def test_each_stage_bit_equal_to_jax(frames, mode):
    info, _ = frames
    infos = load(info)
    ours, theirs = _stages(build_pipeline, mode, 10), _stages(jax_build, mode, 10)
    assert [type(s).__name__ for s in ours] == [type(s).__name__ for s in theirs]
    for fi in (0, 1, 3):
        so, ro = _run(ours, dict(infos[fi]), mode, fi)
        st, rt = _run(theirs, dict(infos[fi]), mode, fi)
        assert [n for n, _ in so] == [n for n, _ in st] == [
            "LoadMultiViewImages", "Preprocess", "ImageAug3D", "GridMask", "ImageNormalize",
            "ReformatCamera"]
        for (name, a), (_, b) in zip(so, st):
            assert set(a) == set(b), name
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (name, k)
        batch = dict(so[-1][1])
        assert batch["images"].shape == (6, 32, 48, 3)
        assert (batch["depth_images"] > 0).sum() > 20
        for k in ("images", "depth_images", "img_aug_rots", "camera2lidar_rots"):
            assert np.array_equal(ro[k], rt[k]), k  # ReformatFixedShape merged them
        if mode == "train":
            raw = np.stack([infos[fi]["cams"][n]["sensor2lidar_rotation"]
                            for n in tcam.DEFAULT_CAMS]).astype(np.float32)
            assert not np.array_equal(batch["camera2lidar_rots"], raw)  # the lidar aug folded in


@pytest.mark.parametrize("mode", ["train", "val"])
def test_dataset_batches_bit_equal_to_jax(frames, mode):
    """The dataset with the camera pipeline through the loader: every key of
    the first two batches of 2."""
    info, _ = frames
    test_mode = mode == "val"
    np.random.seed(4)  # the train set's CBGS resampling draws from numpy's global generator
    ds = NuScenesDataset(info_path=info, nsweeps=1, class_names=CLASSES, test_mode=test_mode,
                         pipeline=pipeline(mode), tasks=TASKS, max_points=4096)
    np.random.seed(4)
    jds = JaxDataset(info_path=info, nsweeps=1, class_names=CLASSES, test_mode=test_mode,
                     pipeline=pipeline(mode), tasks=TASKS, max_points=4096)
    for d in (ds, jds):
        for k, st in enumerate(d.pipeline):
            if hasattr(st, "rng"):
                st.rng = np.random.RandomState(20 + k)
    load_o = [s for s in ds.pipeline if type(s).__name__ == "LoadPointCloudFromFile"][0]
    load_t = [s for s in jds.pipeline if type(s).__name__ == "LoadPointCloudFromFile"][0]
    assert load_o.max_points == load_t.max_points  # the val-mode read cap, or none in train
    np.random.seed(5)
    ours = list(DataLoader(ds, 2, shuffle=False, drop_last=False, prefetch=0))
    np.random.seed(5)
    theirs = list(JaxLoader(jds, 2, shuffle=False, drop_last=False, prefetch=0))
    assert len(ours) == len(theirs) >= 1
    for bo, bt in zip(ours, theirs):
        keys = set(bo) - {"metadata"}
        assert keys == set(bt) - {"metadata"}
        assert {"images", "depth_images", "img_aug_rots", "camera2lidar_trans"} <= keys
        for k in keys:
            a, b = bo[k], bt[k]
            for x, y in (zip(a, b) if isinstance(a, list) else [(a, b)]):
                assert np.array_equal(np.asarray(x), np.asarray(y)), k
    assert os.path.exists(load(info)[0]["cams"]["CAM_FRONT"]["data_path"])
