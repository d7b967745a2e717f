"""GT-AUG of the PyTorch port against the JAX package's, on a synthetic
labeled set and one numpy seed:

- ``data/create_gt_database.py``, with and without an AL suffix, writes
  dbinfos equal to JAX's and bit-equal object ``.bin`` files;
- the db pre-processors (min points, difficulty) give the same dbinfos;
- ``DataBaseSamplerV2.sample_all`` after the same ``np.random.seed`` gives
  bit-equal names, boxes and points, collision rejections included (the JAX
  package takes its native collision test where that library is built, the
  port always its numpy one);
- train-mode ``Preprocess`` with an existing database (the sampler built,
  objects pasted before the augmentations) gives JAX's points and boxes.
"""
import os
import pickle

import numpy as np
import pytest

from dal3d_tpu.data import NuScenesDataset as JaxDataset
from dal3d_tpu.data import sampler as jsampler
from dal3d_tpu.data.create_gt_database import create_groundtruth_database as jax_create
from dal3d_tpu_torch.data import NuScenesDataset
from dal3d_tpu_torch.data import sampler as tsampler
from dal3d_tpu_torch.data.create_gt_database import create_groundtruth_database
from dal3d_tpu_torch.data.datasets.synthetic import DEFAULT_CLASSES, make_synthetic_nuscenes
from dal3d_tpu_torch.utils.fileio import dump, load

GROUPS = [dict(car=6), dict(truck=4), dict(bus=3), dict(pedestrian=8), dict(barrier=6),
          dict(traffic_cone=8), dict(bicycle=4), dict(motorcycle=4), dict(trailer=2),
          dict(construction_vehicle=2)]
PREP = [dict(filter_by_min_num_points={c: 5 for c in DEFAULT_CLASSES}),
        dict(filter_by_difficulty=[-1])]


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """A labeled set (objects crowded into +-8 m, so that pasted boxes
    collide) and its GT database written by each package, in the full set
    and for an AL subset (suffix 3)."""
    tmp = tmp_path_factory.mktemp("gt_aug")
    data = str(tmp / "data")
    info = make_synthetic_nuscenes(data, n_frames=6, n_logs=2, points_per_frame=2000,
                                   range_xy=8.0, seed=3)
    infos = load(info)
    sub = info.replace(".pkl", "_3.pkl")
    dump([infos[i] for i in (4, 1, 5)], sub)
    out = {}
    for name, fn in (("jax", jax_create), ("port", create_groundtruth_database)):
        root = str(tmp / name)
        out[name] = (root, fn(root, info, nsweeps=10), fn(root, sub, nsweeps=10, suffix="3"))
    return info, out


def _equal_dbinfos(a, b):
    assert list(a) == list(b)
    for cls in a:
        assert len(a[cls]) == len(b[cls]) > 0
        for x, y in zip(a[cls], b[cls]):
            assert x.keys() == y.keys()
            for k in x:
                if isinstance(x[k], np.ndarray):
                    assert x[k].dtype == y[k].dtype
                    np.testing.assert_array_equal(x[k], y[k])
                else:
                    assert x[k] == y[k]


@pytest.mark.parametrize("which", [1, 2])  # the full database, the suffixed one
def test_gt_database_equals_jax(dbs, which):
    _, out = dbs
    (jroot, *jpaths), (troot, *tpaths) = out["jax"], out["port"]
    assert os.path.basename(jpaths[which - 1]) == os.path.basename(tpaths[which - 1])
    jdb, tdb = load(jpaths[which - 1]), load(tpaths[which - 1])
    _equal_dbinfos(jdb, tdb)
    n = 0
    for cls_infos in tdb.values():
        for di in cls_infos:
            with open(os.path.join(jroot, di["path"]), "rb") as f:
                jb = f.read()
            with open(os.path.join(troot, di["path"]), "rb") as f:
                assert f.read() == jb
            n += 1
    assert n > 10
    if which == 2:
        assert all(di["path"].startswith("gt_database_10sweeps_withvelo_3/")
                   for v in tdb.values() for di in v)
        assert max(di["image_idx"] for v in tdb.values() for di in v) == 2


def test_db_preprocessors_equal_jax(dbs):
    _, out = dbs
    db = load(out["port"][1])
    steps = PREP + [dict(filter_by_min_num_points=dict(car=500, pedestrian=400))]
    got = tsampler.build_db_preprocessors(steps)(dict(db))
    want = jsampler.build_db_preprocessors(steps)(dict(db))
    _equal_dbinfos(got, want)
    assert sum(map(len, got.values())) < sum(map(len, db.values()))
    assert (tsampler.filter_by_difficulty(db, [0]) == jsampler.filter_by_difficulty(db, [0])
            == {k: [] for k in db})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_all_bit_equal_to_jax(dbs, seed):
    info, out = dbs
    root, dbp, _ = out["port"]
    infos = load(info)
    rejected = 0
    for frame in infos[:4]:
        gt_boxes, gt_names = frame["gt_boxes"], frame["gt_names"]
        res = []
        for mod in (jsampler, tsampler):
            np.random.seed(seed)
            s = mod.DataBaseSamplerV2(dbp, [dict(g) for g in GROUPS],
                                      db_prepor=mod.build_db_preprocessors(PREP), rate=1.0)
            res.append(s.sample_all(root, gt_boxes, gt_names, num_point_features=5))
            res.append(s.sample_all(root, gt_boxes, gt_names, num_point_features=5))
        for j, t in ((res[0], res[2]), (res[1], res[3])):
            assert j.keys() == t.keys()
            for k in j:
                assert j[k].dtype == t[k].dtype
                np.testing.assert_array_equal(j[k], t[k])
        want = sum(max(n - int(np.sum(gt_names == c)), 0) for g in GROUPS for c, n in g.items())
        rejected += want - len(res[2]["gt_names"])
    assert rejected > 0  # collisions were tested and rejected candidates


def test_preprocess_with_an_existing_database_equals_jax(dbs):
    info, out = dbs
    root, dbp, _ = out["port"]
    prep = dict(mode="train", shuffle_points=True, gt_loc_noise=[0.0, 0.0, 0.0],
                gt_rot_noise=[0.0, 0.0], global_rot_noise=[-0.3925, 0.3925],
                global_scale_noise=[0.95, 1.05], class_names=DEFAULT_CLASSES,
                db_sampler=dict(type="GT-AUG", enable=False, db_info_path=dbp,
                                sample_groups=GROUPS, db_prep_steps=PREP, rate=1.0))
    pipeline = [dict(type="LoadPointCloudFromFile", dataset="NuScenesDataset"),
                dict(type="LoadPointCloudAnnotations", with_bbox=True),
                dict(type="Preprocess", cfg=prep)]
    kw = dict(info_path=info, root_path=root, nsweeps=10, class_names=DEFAULT_CLASSES,
              pipeline=pipeline, max_points=100000)
    np.random.seed(4)
    jds = JaxDataset(**kw)
    np.random.seed(4)
    tds = NuScenesDataset(**kw)
    assert tds.pipeline[2].db_sampler is not None  # enable=False is not read, as in JAX
    base = load(info)
    for i in range(3):
        np.random.seed(10 + i)
        j = jds[i]
        np.random.seed(10 + i)
        t = tds[i]
        np.testing.assert_array_equal(t["lidar"]["points"], j["lidar"]["points"])
        for k in ("gt_boxes", "gt_names", "gt_classes"):
            np.testing.assert_array_equal(t["lidar"]["annotations"][k],
                                          j["lidar"]["annotations"][k])
        token = t["metadata"]["token"]
        n_gt = len(next(b for b in base if b["token"] == token)["gt_names"])
        assert len(t["lidar"]["annotations"]["gt_names"]) > n_gt  # objects were pasted


def test_missing_database_means_no_sampler(tmp_path):
    prep = dict(mode="train", class_names=["car"],
                db_sampler=dict(db_info_path=str(tmp_path / "none.pkl"), sample_groups=[]))
    from dal3d_tpu_torch.data.pipelines.preprocess import Preprocess

    assert Preprocess(prep).db_sampler is None
    with open(tmp_path / "db.pkl", "wb") as f:
        pickle.dump({"car": []}, f)
    prep["db_sampler"]["db_info_path"] = str(tmp_path / "db.pkl")
    assert isinstance(Preprocess(prep).db_sampler, tsampler.DataBaseSamplerV2)
