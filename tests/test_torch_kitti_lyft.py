"""The KITTI and Lyft datasets and evaluations of the PyTorch port against the
JAX package's, on the CPU:

- ``eval/kitti_official.py`` gives JAX's metrics, every key and value
  equal, on JAX's own hand fixtures (tests/test_kitti_official.py) and on
  seeded random scenes, and JAX's overlaps;
- ``eval/lyft_eval.py`` gives JAX's score within 1e-6 on JAX's hand
  fixtures (tests/test_lyft_eval.py) and on seeded random frames;
- ``KittiDataset`` (on the synthetic scenes written as KITTI by
  ``make_synthetic_kitti``: 4-feature velodyne files, camera-frame labels,
  a ``DontCare`` a frame) and ``LyftDataset`` give JAX's samples bit for
  bit, in test mode and in train mode with equal numpy seeds, and JAX's
  ``evaluation`` (the frames, with KITTI's difficulty fields, each hands
  its ``kitti_eval`` / ``lyft_eval``; Lyft's submission file);
- the factory builds both under their short and class names."""
import functools
import json
import os

import jax
import numpy as np
import pytest

from dal3d_tpu.eval import kitti_official as jko
from dal3d_tpu.eval import lyft_eval as jlyft
from dal3d_tpu_torch.data.dataset_factory import get_dataset_cls
from dal3d_tpu_torch.data.datasets.kitti import KittiDataset
from dal3d_tpu_torch.data.datasets.lyft import LYFT_CLASSES, LyftDataset
from dal3d_tpu_torch.data.datasets.synthetic import make_synthetic_kitti, make_synthetic_nuscenes
from dal3d_tpu_torch.eval import kitti_official as ko
from dal3d_tpu_torch.eval import lyft_eval
from test_kitti_official import _anno, _bbox, _car, _grid_scene
from test_torch_transforms_extra import _same

KITTI_CLASSES = ["Car", "Pedestrian", "Cyclist"]


def _hand_scenes():
    """The scenes of JAX's tests/test_kitti_official.py."""
    small = [10, 10, 110, 40]
    shifted = _grid_scene()[1]
    for d in shifted:
        d["location"] = d["location"] + np.array([0.8, 0.0, 0.0])
    return {
        "perfect": _grid_scene(),
        "flipped_alpha": _grid_scene(dt_alpha=np.pi),
        "van": _grid_scene(gt_extra=[("Van", _car(90, 90), _bbox(19))],
                           extra_dt=[("Car", _car(90, 90), _bbox(19), 0.5)]),
        "stray": _grid_scene(extra_dt=[("Car", _car(90, 95), _bbox(19), 0.5)]),
        "dontcare": _grid_scene(gt_extra=[("DontCare", _car(0, 0), [300, 10, 400, 60])],
                                extra_dt=[("Car", _car(90, 95), [300, 10, 400, 60], 0.5)]),
        "small_gt": _grid_scene(gt_extra=[("Car", _car(90, 90), small)],
                                extra_dt=[("Car", _car(90, 90), small, 0.5)]),
        "sparse": ([_anno(["Car", "Car"], [_car(0, 10), _car(5, 20)], [_bbox(0), _bbox(1)])],
                   [_anno(["Car"], [_car(0, 10)], [_bbox(0)], scores=[0.9], alphas=[-10])]),
        "shifted": (_grid_scene()[0], shifted),
    }


def _random_scenes(seed, frames=4):
    """Cars, pedestrians and cyclists with noisy, partly missing and partly
    spurious detections, random truncation, occlusion and image heights."""
    rng = np.random.RandomState(seed)
    gts, dts = [], []
    for _ in range(frames):
        n = rng.randint(8, 20)
        names = list(rng.choice(KITTI_CLASSES + ["Van", "DontCare"], n))
        boxes = np.column_stack([rng.uniform(-20, 20, n), rng.uniform(1, 2, n),
                                 rng.uniform(5, 60, n), rng.uniform(0.5, 4.5, (n, 3)),
                                 rng.uniform(-3, 3, n)])
        top = rng.uniform(0, 200, n)
        bbs = np.column_stack([rng.uniform(0, 500, n), top, rng.uniform(500, 900, n),
                               top + rng.uniform(15, 80, n)])
        gts.append(_anno(names, boxes, bbs, occluded=rng.randint(0, 3, n),
                         truncated=rng.uniform(0, 0.6, n), alphas=rng.uniform(-3, 3, n)))
        keep = rng.rand(n) < 0.8
        m = int(keep.sum()) + 3
        dnames = [nm if nm != "DontCare" else "Car" for nm in np.asarray(names)[keep]]
        dnames += list(rng.choice(KITTI_CLASSES, 3))
        dboxes = np.vstack([boxes[keep] + rng.normal(0, 0.3, (keep.sum(), 7)),
                            np.column_stack([rng.uniform(-20, 20, 3), rng.uniform(1, 2, 3),
                                             rng.uniform(5, 60, 3), rng.uniform(1, 4, (3, 3)),
                                             rng.uniform(-3, 3, 3)])])
        dbbs = np.vstack([bbs[keep] + rng.normal(0, 3, (keep.sum(), 4)),
                          bbs[rng.randint(n, size=3)]])
        dts.append(_anno(dnames, dboxes, dbbs, scores=rng.rand(m),
                         alphas=rng.uniform(-3, 3, m)))
    return gts, dts


def _scenes():
    """JAX's hand scenes whose decisions differ most (the similar class, the
    DontCare region, the sparse curve, the failed strict overlap) and a
    seeded random scene (difficulty bins of every kind); the others of JAX's
    file take the same paths."""
    hand = _hand_scenes()
    out = {k: hand[k] for k in ("van", "dontcare", "sparse", "shifted")}
    out["random"] = _random_scenes(0, frames=3)
    return out


@pytest.mark.parametrize("scene", sorted(_scenes()))
def test_kitti_official_equals_jax(scene):
    """Every key and value of the official result (R11 / R40, bbox / BEV /
    3D / AOS, easy / moderate / hard); the coco sweep (the same matching at
    ten overlaps) on the smallest scene."""
    gt, dt = _scenes()[scene]
    classes = KITTI_CLASSES if scene == "random" else ["Car"]
    fns = ["get_official_eval_result"]
    if scene == "sparse":
        fns.append("get_coco_eval_result")
    for fn in fns:
        want = getattr(jko, fn)(gt, dt, classes)
        got = getattr(ko, fn)(gt, dt, classes)
        assert got == want


def test_kitti_official_overlaps_equal_jax():
    rng = np.random.RandomState(4)
    a = np.column_stack([rng.uniform(-5, 5, (30, 3)), rng.uniform(0.5, 4, (30, 3)),
                         rng.uniform(-3, 3, 30)])
    b = a[rng.permutation(30)] + rng.normal(0, 0.5, (30, 7))
    bb_a = np.sort(rng.uniform(0, 300, (30, 4)).reshape(30, 2, 2), axis=1).reshape(30, 4)
    bb_b = bb_a + rng.normal(0, 10, (30, 4))
    for crit in (-1, 0, 1):
        assert np.array_equal(ko.image_box_overlap(bb_a, bb_b, crit),
                              jko.image_box_overlap(bb_a, bb_b, crit))
    bev = a[:, [0, 2, 3, 5, 6]], b[:, [0, 2, 3, 5, 6]]
    assert np.array_equal(ko.bev_box_overlap(*bev), jko.bev_box_overlap(*bev))
    assert np.array_equal(ko.d3_box_overlap(a, b), jko.d3_box_overlap(a, b))


def _lyft_box(x, y, yaw=0.0):
    return [x, y, 0.0, 1.8, 4.2, 1.6, 0.0, 0.0, yaw]  # tests/test_lyft_eval.py's _box


def _lyft_frames():
    one = np.array([_lyft_box(0, 0)])
    sets = {
        "perfect": ([{"boxes": np.array([_lyft_box(0, 0), _lyft_box(10, 0)]),
                      "names": np.array(["car", "pedestrian"])}],
                    [{"boxes": np.array([_lyft_box(0, 0), _lyft_box(10, 0)]),
                      "names": np.array(["car", "pedestrian"]), "scores": np.array([0.9, 0.8])}]),
        "shifted": ([{"boxes": one, "names": np.array(["car"])}],
                    [{"boxes": np.array([[0.5, 0.0, 0.0, 1.8, 4.2, 1.6, 0, 0, 0.0]]),
                      "names": np.array(["car"]), "scores": np.array([0.9])}]),
        "wrong_class": ([{"boxes": one, "names": np.array(["car"])}],
                        [{"boxes": one, "names": np.array(["truck"]),
                          "scores": np.array([0.9])}]),
    }
    rng = np.random.RandomState(8)
    gts, preds = [], []
    for _ in range(3):  # a box of each of four classes a frame: every pair is
        n = 4           # [1, 1], the one shape JAX's IoU compiles for
        g = np.column_stack([rng.uniform(-12, 12, (n, 2)), rng.uniform(-2, 0, n),
                             rng.uniform(0.5, 3, (n, 2)), rng.uniform(1, 3, n),
                             np.zeros((n, 2)), rng.uniform(-3, 3, n)])
        gn = np.asarray(LYFT_CLASSES[:n])
        p = g + rng.normal(0, 0.15, g.shape) * np.array([1, 1, 1, 1, 1, 1, 0, 0, 1])
        gts.append({"boxes": g, "names": gn})
        preds.append({"boxes": p, "names": gn.copy(), "scores": rng.rand(n)})
    sets["random"] = (gts, preds)
    return sets


@functools.lru_cache(maxsize=None)
def _jitted_iou3d():
    from dal3d_tpu.ops import rotated_iou

    return jax.jit(rotated_iou.boxes_iou3d)


@pytest.mark.parametrize("case", sorted(_lyft_frames()))
def test_lyft_eval_equals_jax(case, monkeypatch):
    """JAX's ``boxes_iou3d`` runs jitted (eagerly it compiles op by op);
    every pair here is [1, 1], so it compiles once for the file."""
    from dal3d_tpu.ops import rotated_iou

    monkeypatch.setattr(rotated_iou, "boxes_iou3d", _jitted_iou3d())
    gt, pred = _lyft_frames()[case]
    classes = list(LYFT_CLASSES)
    want = jlyft.lyft_eval(gt, pred, classes)
    got = lyft_eval.lyft_eval(gt, pred, classes, device="cpu")
    assert abs(got["lyft_score"] - want["lyft_score"]) <= 1e-6
    assert got["per_threshold"].keys() == want["per_threshold"].keys()
    for k, v in want["per_threshold"].items():
        assert abs(got["per_threshold"][k] - v) <= 1e-6
    if case == "random":
        assert 0.0 < want["lyft_score"] < 1.0


def test_lyft_eval_takes_frames_without_boxes():
    """A frame without a detection, and one without a GT box: the port
    scores them (no match there: 0 for the first, as every unmatched GT;
    nothing to count for an empty pair); JAX's evaluation raises on them
    (``np.reshape(0, -1)``), a reference defect (ROADMAP C.4)."""
    box = np.array([_lyft_box(0, 0)])
    gt = [{"boxes": box, "names": np.array(["car"])},
          {"boxes": np.zeros((0, 9)), "names": np.array([], dtype="<U3")}]
    pred = [{"boxes": np.zeros((0, 9)), "names": np.array([], dtype="<U3"),
             "scores": np.zeros(0)},
            {"boxes": box, "names": np.array(["car"]), "scores": np.array([0.5])}]
    got = lyft_eval.lyft_eval(gt, pred, ["car"], device="cpu")
    assert got["lyft_score"] == 0.0 and set(got["per_threshold"].values()) == {0.0}
    with pytest.raises(ValueError, match="reshape"):
        jlyft.lyft_eval(gt, pred, ["car"])
    both = lyft_eval.lyft_eval(gt[:1] * 2, [pred[1], pred[0]], ["car"], device="cpu")
    assert both["lyft_score"] == 0.5  # the matched frame 1, the empty one 0


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_lyft")
    nusc = make_synthetic_nuscenes(str(root / "nusc"), n_frames=4, n_logs=2,
                                   points_per_frame=1500, range_xy=6.0, max_boxes=6, seed=3,
                                   classes=["car", "pedestrian", "bicycle"])
    return root, nusc, make_synthetic_kitti(nusc, str(root / "kitti"))


def _pipeline(mode):
    """The train pipeline adds six of the extra stages after Preprocess; the
    random ones get their own seeded generators (a fresh RandomState a
    call, so that each package gets an equal one)."""
    prep = dict(mode=mode, shuffle_points=mode == "train")
    if mode == "train":
        prep.update(global_rot_noise=[-0.3925, 0.3925], global_scale_noise=[0.95, 1.05],
                    class_names=["car", "pedestrian", "bicycle"])
    stages = [dict(type="LoadPointCloudFromFile", dataset="NuScenesDataset"),
              dict(type="LoadPointCloudAnnotations", with_bbox=True),
              dict(type="Preprocess", cfg=prep)]
    if mode == "train":
        stages += [dict(type="GlobalRotScaleTrans", rot_lim=(-0.3, 0.3),
                        rng=np.random.RandomState(1)),
                   dict(type="RandomFlip3D", rng=np.random.RandomState(2)),
                   dict(type="PointsRangeFilter", point_cloud_range=[-6.4, -6.4, -5, 6.4, 6.4, 3]),
                   dict(type="ObjectRangeFilter", point_cloud_range=[-6.4, -6.4, -5, 6.4, 6.4, 3]),
                   dict(type="ObjectNameFilter", classes=["car", "pedestrian", "bicycle"]),
                   dict(type="PointShuffle", rng=np.random.RandomState(3))]
    return stages + [dict(type="ReformatFixedShape")]


TASKS = [dict(num_class=1, class_names=["car"]),
         dict(num_class=2, class_names=["pedestrian", "bicycle"])]


def _detections(infos, tokens, boxes_key, rng, classes):
    """For the first two frames (JAX's eager IoUs compile for every new
    shape): the GT boxes moved a little, with random scores, padded."""
    dets = {}
    for token, info in list(zip(tokens, infos))[:2]:
        boxes, names = boxes_key(info)
        n = len(boxes)
        pad = 10
        b = np.zeros((pad, 9), np.float32)
        b[:n] = boxes + rng.normal(0, 0.1, boxes.shape) * [1, 1, 1, 0, 0, 0, 0, 0, 1]
        labels = np.zeros(pad, np.int64)
        labels[:n] = [classes.index(nm) for nm in names]
        valid = np.zeros(pad, bool)
        valid[:n] = True
        dets[token] = {"box3d_lidar": b, "scores": rng.rand(pad).astype(np.float32),
                       "label_preds": labels, "det_valid": valid}
    return dets


@pytest.mark.parametrize("mode", ["val", "train"])
def test_kitti_dataset_equals_jax(scenes, mode, monkeypatch):
    from dal3d_tpu.data.datasets.kitti import KittiDataset as JKitti
    from dal3d_tpu.data.datasets.kitti import camera_to_lidar_boxes as jcam

    _, _, info = scenes
    classes = ["car", "pedestrian", "bicycle"]
    kw = dict(info_path=info, class_names=classes, tasks=TASKS, test_mode=mode == "val",
              max_points=2000)
    j, p = JKitti(pipeline=_pipeline(mode), **kw), KittiDataset(pipeline=_pipeline(mode), **kw)
    assert len(j) == len(p) == 4
    for i in range(len(j)):
        np.random.seed(i)
        want = j[i]
        np.random.seed(i)
        _same(want, p[i])
    if mode == "train":
        return
    rng = np.random.RandomState(0)

    def boxes(info):
        annos = {k: np.asarray(v)[:-1] for k, v in info["annos"].items()}  # DontCare is last
        return jcam(annos, info["calib"]), annos["name"]

    dets = _detections(p.infos, [str(i["image_idx"]) for i in p.infos], boxes, rng, classes)
    # the frames each package hands its kitti_eval (tests/test_torch_eval.py
    # holds the two kitti_evals equal; JAX's eager IoUs compile for every
    # new shape, so its metrics are not computed again here)
    seen = {}

    def record(tag):
        def kitti_eval(gt, preds, names, device=None):
            seen[tag] = (gt, preds, names)
            return {"results": {}}
        return kitti_eval

    import dal3d_tpu.eval.kitti_eval as jke
    import dal3d_tpu_torch.eval.kitti_eval as tke

    with monkeypatch.context() as mp:
        mp.setattr(jke, "kitti_eval", record("jax"))
        mp.setattr(tke, "kitti_eval", record("port"))
        j.evaluation(dets)
        p.evaluation(dets, device="cpu")
    _same(seen["jax"], seen["port"])
    assert {"bbox", "occluded", "truncated"} <= set(seen["port"][0][0])
    got = p.evaluation(dets, device="cpu")["results"]
    assert "mAP_3d_moderate" in got and got["mAP_bev"] > 0.0


@pytest.mark.parametrize("mode", ["val", "train"])
def test_lyft_dataset_equals_jax(scenes, mode, tmp_path, monkeypatch):
    from dal3d_tpu.data.datasets.lyft import LyftDataset as JLyft

    _, info, _ = scenes
    kw = dict(info_path=info, nsweeps=1, tasks=TASKS, test_mode=mode == "val", max_points=2000)
    np.random.seed(5)  # train mode: the CBGS resampling
    j = JLyft(pipeline=_pipeline(mode), **kw)
    np.random.seed(5)
    p = LyftDataset(pipeline=_pipeline(mode), **kw)
    assert p.class_names == list(LYFT_CLASSES) and len(j) == len(p)
    for i in range(len(j)):
        np.random.seed(i)
        want = j[i]
        np.random.seed(i)
        _same(want, p[i])
    if mode == "train":
        return
    rng = np.random.RandomState(1)
    dets = _detections(p.infos[:1], [p.infos[0]["token"]],
                       lambda i: (np.asarray(i["gt_boxes"]), np.asarray(i["gt_names"])), rng,
                       list(LYFT_CLASSES))
    os.makedirs(tmp_path / "jax"), os.makedirs(tmp_path / "port")
    # the frames each package hands its lyft_eval (test_lyft_eval_equals_jax
    # holds the two lyft_evals equal; JAX's eager IoUs compile per shape)
    seen = {}

    def record(tag):
        def fake(gt, preds, names, device=None):
            seen[tag] = (gt, preds, names)
            return {}
        return fake

    import dal3d_tpu.eval.lyft_eval as jle
    import dal3d_tpu_torch.eval.lyft_eval as tle

    with monkeypatch.context() as mp:
        mp.setattr(jle, "lyft_eval", record("jax"))
        mp.setattr(tle, "lyft_eval", record("port"))
        j.evaluation(dets, output_dir=str(tmp_path / "jax"))
        p.evaluation(dets, output_dir=str(tmp_path / "port"), device="cpu")
    _same(seen["jax"], seen["port"])
    got = p.evaluation(dets, output_dir=str(tmp_path / "port"), device="cpu")["results"]
    assert 0.0 < got["lyft_score"] < 1.0
    with open(tmp_path / "jax" / "results_lyft.json") as f:
        a = json.load(f)
    with open(tmp_path / "port" / "results_lyft.json") as f:
        assert json.load(f) == a


def test_factory_builds_kitti_and_lyft():
    for name in ("KITTI", "KittiDataset"):
        assert get_dataset_cls(name) is KittiDataset
    for name in ("LYFT", "LyftDataset"):
        assert get_dataset_cls(name) is LyftDataset
