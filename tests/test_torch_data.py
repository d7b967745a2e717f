"""The pool's data path of the PyTorch port against the JAX package's, on the
same synthetic pool and numpy seed: host mean voxelizer, the four val-mode
pipeline stages, dataset and loader.

Voxel coords / valid are equal; mean features agree within 1e-6 relative
(the port sums each voxel in f64, the native voxelizer in f32)."""
import numpy as np
import pytest
import torch

from dal3d_tpu.data import DataLoader as JaxLoader
from dal3d_tpu.data import NuScenesDataset as JaxDataset
from dal3d_tpu.data.datasets.synthetic import make_synthetic_nuscenes as jax_synth
from dal3d_tpu.native import host_ops
from dal3d_tpu_torch.core.voxel_generator import points_to_voxel_mean
from dal3d_tpu_torch.data import DataLoader, NuScenesDataset, build_pipeline
from dal3d_tpu_torch.data.datasets.synthetic import make_synthetic_nuscenes
from dal3d_tpu_torch.models.builder import host_voxelize_cfg, loader_voxelize_cfg
from dal3d_tpu_torch.utils.fileio import load

VOXEL = dict(range=[-51.2, -51.2, -5.0, 51.2, 51.2, 3.0], voxel_size=[0.1, 0.1, 0.2],
             max_points_in_voxel=3, max_voxel_num=4000)
TASKS = [dict(num_class=1, class_names=["car"])]
PIPELINE = [
    dict(type="LoadPointCloudFromFile", dataset="NuScenesDataset"),
    dict(type="LoadPointCloudAnnotations", with_bbox=True),
    dict(type="Preprocess", cfg=dict(mode="val", shuffle_points=False)),
    dict(type="ReformatFixedShape"),
]


def _cloud(seed, n=30000):
    rng = np.random.RandomState(seed)
    p = np.zeros((n, 5), np.float32)
    p[:, :2] = rng.uniform(-60, 60, (n, 2))  # some fall outside the range
    p[:, 2] = rng.uniform(-6, 4, n)
    p[:, 3] = rng.uniform(0, 255, n)
    # dense clusters: many points per voxel, so max_points truncates
    p[: n // 3, :3] = rng.uniform(-2, 2, (n // 3, 3))
    return p


@pytest.mark.parametrize("max_points,max_voxels", [(10, 60000), (3, 2000), (1, 100)])
def test_voxelizer_matches_native(max_points, max_voxels):
    pts = _cloud(0)
    ref_f, ref_c, ref_n = host_ops.points_to_voxel_mean(
        pts, VOXEL["voxel_size"], VOXEL["range"], max_points, max_voxels, n_threads=1)
    f, c, n = points_to_voxel_mean(pts, VOXEL["voxel_size"], VOXEL["range"], max_points,
                                   max_voxels)
    assert f.dtype == np.float32 and c.dtype == np.int32 and len(f) == len(ref_f) > 0
    if max_voxels < 60000:
        assert len(f) == max_voxels  # truncated in first-appearance order
    np.testing.assert_array_equal(c, ref_c)
    np.testing.assert_array_equal(n, ref_n)
    np.testing.assert_allclose(f, ref_f, rtol=1e-6, atol=1e-6)


def test_voxelizer_bf16_rounds_the_f32_mean():
    pts = _cloud(1, 5000)
    f32, c32, _ = points_to_voxel_mean(pts, VOXEL["voxel_size"], VOXEL["range"], 10, 60000)
    bf, c, _ = points_to_voxel_mean(pts, VOXEL["voxel_size"], VOXEL["range"], 10, 60000,
                                    bf16=True)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(c, c32)
    assert torch.equal(bf, torch.from_numpy(f32).to(torch.bfloat16))
    ref, _, _ = host_ops.points_to_voxel_mean(pts, VOXEL["voxel_size"], VOXEL["range"], 10,
                                              60000, n_threads=1, bf16=True)
    # the means differ in the last f32 bit, so bf16 may round across one ulp
    np.testing.assert_allclose(bf.float().numpy(), np.asarray(ref, np.float32), rtol=2.0 ** -7,
                               atol=1e-6)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc"))
    return make_synthetic_nuscenes(root, n_frames=5, n_logs=2, points_per_frame=1500, seed=3)


def test_synthetic_pool_matches_jax(pool, tmp_path):
    ref = load(jax_synth(str(tmp_path / "ref"), n_frames=5, n_logs=2, points_per_frame=1500,
                         seed=3))
    got = load(pool)
    assert len(got) == len(ref) == 5
    for a, b in zip(got, ref):
        assert a.keys() == b.keys()
        np.testing.assert_array_equal(a["gt_boxes"], b["gt_boxes"])
        assert list(a["gt_names"]) == list(b["gt_names"])
        assert a["cam_front_path"].split("/")[-1] == b["cam_front_path"].split("/")[-1]
        np.testing.assert_array_equal(np.fromfile(a["lidar_path"], np.float32),
                                      np.fromfile(b["lidar_path"], np.float32))
        assert len(a["sweeps"]) == len(b["sweeps"]) == 9


def _datasets(pool, max_points=300000):
    kw = dict(info_path=pool, nsweeps=10, class_names=["car"], pipeline=PIPELINE, tasks=TASKS,
              max_points=max_points, voxelize_host=VOXEL, test_mode=True)
    return JaxDataset(**kw), NuScenesDataset(**kw)


@pytest.mark.parametrize("num_workers", [1, 3])
def test_loader_matches_jax(pool, num_workers):
    """5 frames at batch 2: three batches, the last padded with the last
    frame, in the same order at 1 and 3 workers. The sweep order of a frame
    is drawn from numpy's global generator, so only one worker draws it in
    JAX's order: values are compared there, order and validity at 3."""
    jds, tds = _datasets(pool)
    np.random.seed(5)
    ref = list(JaxLoader(jds, 2, shuffle=False, drop_last=False))
    np.random.seed(5)
    got = list(DataLoader(tds, 2, shuffle=False, drop_last=False, num_workers=num_workers))
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        assert [m["token"] for m in a["metadata"]] == [m["token"] for m in b["metadata"]]
        np.testing.assert_array_equal(a["voxel_valid"], b["voxel_valid"])
        assert a["voxel_valid"].shape == (2, VOXEL["max_voxel_num"])
        if num_workers == 1:
            np.testing.assert_array_equal(a["voxel_coords"], b["voxel_coords"])
            np.testing.assert_allclose(a["voxel_features"], b["voxel_features"], rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_array_equal(a["points"], b["points"])
            np.testing.assert_array_equal(a["points_valid"], b["points_valid"])
    assert [m["token"] for m in got[-1]["metadata"]] == ["synthtoken000004"] * 2


def test_sweep_cap_reads_the_same_points(pool):
    """With max_points below the 10-sweep total the val-mode cap stops the
    reads early; the example equals JAX's, which equals an uncapped read cut
    to max_points."""
    jds, tds = _datasets(pool, max_points=4000)
    assert tds.pipeline[0].max_points == 4000
    np.random.seed(9)
    ref = jds[2]
    np.random.seed(9)
    got = tds[2]
    np.testing.assert_array_equal(got["points"], ref["points"])
    np.testing.assert_array_equal(got["voxel_coords"], ref["voxel_coords"])
    assert int(got["points_valid"].sum()) == 4000
    # a shuffling Preprocess disables the cap
    stages = build_pipeline([PIPELINE[0], dict(type="Preprocess",
                                               cfg=dict(mode="val", shuffle_points=True)),
                             PIPELINE[3]], tasks=TASKS, max_points=4000)
    assert stages[0].max_points is None


def test_bf16_batches_stack_as_tensors(pool):
    vh = dict(VOXEL, bf16=True)
    ds = NuScenesDataset(info_path=pool, nsweeps=10, pipeline=PIPELINE, tasks=TASKS,
                         voxelize_host=vh, test_mode=True)
    np.random.seed(0)
    batch = next(iter(DataLoader(ds, 2, shuffle=False, drop_last=False, prefetch=0)))
    assert isinstance(batch["voxel_features"], torch.Tensor)
    assert batch["voxel_features"].dtype == torch.bfloat16
    assert batch["voxel_features"].shape == (2, VOXEL["max_voxel_num"], 5)
    assert batch["voxel_coords"].dtype == np.int32


def test_train_mode_is_not_ported(pool):
    """What train mode still refuses: a GT-AUG sampler whose database file
    exists (as in the JAX package, a missing file means no sampler) and the
    camera stages. The train-mode dataset and Preprocess themselves are ported
    (tests/test_torch_train_data.py)."""
    train = dict(mode="train", class_names=["car"])
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        build_pipeline([dict(type="Preprocess", cfg=dict(train, db_sampler=dict(
            db_info_path=pool, sample_groups=[dict(car=2)])))], tasks=TASKS)
    stages = build_pipeline([dict(type="Preprocess", cfg=dict(train, db_sampler=dict(
        db_info_path=pool + ".missing", sample_groups=[dict(car=2)])))], tasks=TASKS)
    assert stages[0].mode == "train"
    ds = NuScenesDataset(info_path=pool, class_names=["car"], pipeline=PIPELINE, tasks=TASKS)
    assert not ds.test_mode and len(ds) > 0
    with pytest.raises(KeyError):
        build_pipeline([dict(type="LoadMultiViewImages")], tasks=TASKS)


def test_voxelize_cfg_has_no_host_plans():
    from torch_port_utils import small_cfg

    cfg = small_cfg()
    vh = loader_voxelize_cfg(cfg)
    assert vh == host_voxelize_cfg(cfg) == dict(cfg["voxel_generator"]) and "brick" not in vh
    assert host_voxelize_cfg(dict(cfg, voxelize_host=False)) is None
