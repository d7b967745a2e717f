"""The train-mode data path of the PyTorch port against the JAX package's on
the same synthetic labeled set and numpy seed: CBGS resampling, the
augmentations of Preprocess, the per-task GT split of ReformatFixedShape, and
the shuffling loader.

Every draw (resampling, sweep choice, flip / rotation / scale, per-object
noise, point shuffle) comes from numpy's global generator in the same order
in both packages, so after ``np.random.seed(s)`` the resampled index list and
the batches (points, gt_boxes, gt_classes) are equal byte for byte; one loader
thread, as the CLI uses."""
import numpy as np
import pytest

from dal3d_tpu.data import DataLoader as JaxLoader
from dal3d_tpu.data import NuScenesDataset as JaxDataset
from dal3d_tpu.data.pipelines import augment as jax_augment
from dal3d_tpu_torch.data import DataLoader, NuScenesDataset
from dal3d_tpu_torch.data.datasets.synthetic import DEFAULT_CLASSES, make_synthetic_nuscenes
from dal3d_tpu_torch.data.pipelines import augment

VOXEL = dict(range=[-51.2, -51.2, -5.0, 51.2, 51.2, 3.0], voxel_size=[0.1, 0.1, 0.2],
             max_points_in_voxel=3, max_voxel_num=4000)
TASKS = [
    dict(num_class=1, class_names=["car"]),
    dict(num_class=2, class_names=["truck", "construction_vehicle"]),
    dict(num_class=2, class_names=["bus", "trailer"]),
    dict(num_class=1, class_names=["barrier"]),
    dict(num_class=2, class_names=["motorcycle", "bicycle"]),
    dict(num_class=2, class_names=["pedestrian", "traffic_cone"]),
]


def _pipeline(gt_noise: bool, tmp):
    prep = dict(
        mode="train", shuffle_points=True,
        gt_loc_noise=[0.25, 0.25, 0.0] if gt_noise else [0.0, 0.0, 0.0],
        gt_rot_noise=[-0.15, 0.15] if gt_noise else [0.0, 0.0],
        global_rot_noise=[-0.3925, 0.3925], global_scale_noise=[0.95, 1.05],
        # the database file does not exist: no GT sampler in either package
        db_sampler=dict(type="GT-AUG", db_info_path=str(tmp / "missing_dbinfos.pkl"),
                        sample_groups=[dict(car=2)], db_prep_steps=[], rate=1.0),
        class_names=DEFAULT_CLASSES)
    return [dict(type="LoadPointCloudFromFile", dataset="NuScenesDataset"),
            dict(type="LoadPointCloudAnnotations", with_bbox=True),
            dict(type="Preprocess", cfg=prep),
            dict(type="ReformatFixedShape")]


@pytest.fixture(scope="module")
def labeled(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc_train"))
    return make_synthetic_nuscenes(root, n_frames=6, n_logs=2, points_per_frame=1200, seed=7)


def _both(labeled, tmp, seed, gt_noise=False, max_points=20000):
    kw = dict(info_path=labeled, nsweeps=10, class_names=DEFAULT_CLASSES,
              pipeline=_pipeline(gt_noise, tmp), tasks=TASKS, max_points=max_points,
              voxelize_host=VOXEL)
    np.random.seed(seed)
    jds = JaxDataset(**kw)
    np.random.seed(seed)
    tds = NuScenesDataset(**kw)
    return jds, tds


def test_cbgs_resampling_matches_jax(labeled, tmp_path):
    jds, tds = _both(labeled, tmp_path, seed=11)
    ref = [i["token"] for i in jds.infos]
    assert [i["token"] for i in tds.infos] == ref
    assert len(ref) != 6 and len(set(ref)) > 1  # resampled: frames repeat
    # another seed draws another list
    _, other = _both(labeled, tmp_path, seed=12)
    assert [i["token"] for i in other.infos] != ref
    # test mode keeps the infos as they are
    val = NuScenesDataset(info_path=labeled, test_mode=True)
    assert len(val) == 6


@pytest.mark.parametrize("gt_noise", [False, True])
def test_train_batches_match_jax_byte_for_byte(labeled, tmp_path, gt_noise):
    jds, tds = _both(labeled, tmp_path, seed=3, gt_noise=gt_noise)
    np.random.seed(21)
    ref = list(JaxLoader(jds, 2, shuffle=True, seed=0))
    np.random.seed(21)
    got = list(DataLoader(tds, 2, shuffle=True, seed=0))
    assert len(got) == len(ref) == len(tds) // 2 >= 2  # drop_last
    n_gt = 0
    for a, b in zip(got, ref):
        assert [m["token"] for m in a["metadata"]] == [m["token"] for m in b["metadata"]]
        assert a["points"].tobytes() == b["points"].tobytes()
        np.testing.assert_array_equal(a["points_valid"], b["points_valid"])
        assert len(a["gt_boxes"]) == len(b["gt_boxes"]) == len(TASKS)
        for t in range(len(TASKS)):
            assert a["gt_boxes"][t].shape == (2, 128, 9) and a["gt_boxes"][t].dtype == np.float32
            assert a["gt_boxes"][t].tobytes() == b["gt_boxes"][t].tobytes()
            assert a["gt_classes"][t].tobytes() == b["gt_classes"][t].tobytes()
            n_gt += int((a["gt_classes"][t] > 0).sum())
            yaw = a["gt_boxes"][t][..., 8]
            assert float(yaw.min()) >= -np.pi and float(yaw.max()) < np.pi
        np.testing.assert_array_equal(a["voxel_coords"], b["voxel_coords"])
        np.testing.assert_array_equal(a["voxel_valid"], b["voxel_valid"])
        np.testing.assert_allclose(a["voxel_features"], b["voxel_features"], rtol=1e-6, atol=1e-6)
    assert n_gt > 10
    # the epoch seed orders the batches: another seed, another order
    np.random.seed(21)
    other = list(DataLoader(tds, 2, shuffle=True, seed=1))
    assert ([m["token"] for x in other for m in x["metadata"]]
            != [m["token"] for x in got for m in x["metadata"]])


def test_augmentations_match_jax():
    """The five augmentation functions on the same boxes, points and seed."""
    rng = np.random.RandomState(0)
    boxes = np.zeros((6, 9), np.float32)
    boxes[:, :2] = rng.uniform(-20, 20, (6, 2))
    boxes[:, 2] = -1.0
    boxes[:, 3:6] = [2.0, 4.5, 1.6]
    boxes[:, 6:8] = rng.uniform(-2, 2, (6, 2))
    boxes[:, 8] = rng.uniform(-3, 3, 6)
    boxes[1, :2] = boxes[0, :2] + [2.5, 0.0]  # neighbours: the collision test rejects poses
    pts = np.zeros((3000, 5), np.float32)
    pts[:, :3] = rng.uniform(-25, 25, (3000, 3)) * [1, 1, 0.05]
    pts[:600, :3] = (boxes[rng.randint(0, 6, 600), :3]
                     + rng.uniform(-0.9, 0.9, (600, 3)) * [1, 1, 0.5] + [0, 0, 0.8])
    mask = np.array([1, 1, 1, 0, 1, 1], bool)

    def run(mod):
        np.random.seed(4)
        b, p = boxes.copy(), pts.copy()
        mod.noise_per_object(b, p, mask, rotation_perturb=[-0.3, 0.3],
                             center_noise_std=[0.5, 0.5, 0.1])
        rec = {}
        b, p = mod.random_flip_both(b, p, record=rec)
        b, p = mod.global_rotation(b, p, rotation=[-0.4, 0.4], record=rec)
        b, p = mod.global_scaling_v2(b, p, 0.9, 1.1, record=rec)
        b, p = mod.global_translate(b, p, noise_std=(0.2, 0.2, 0.2))
        return b, p, rec

    (rb, rp, rrec), (gb, gp, grec) = run(jax_augment), run(augment)
    assert gb.tobytes() == rb.tobytes() and gp.tobytes() == rp.tobytes() and grec == rrec
    assert not np.array_equal(gb[:, :2], boxes[:, :2]) and not np.array_equal(gp, pts)
