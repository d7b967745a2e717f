"""Port parity of the evaluation's host code against the JAX package, on
seeded numpy inputs:

- ``eval/kitti_eval.py::kitti_eval`` (AP-40, greedy matching, difficulty
  bins) equals JAX's result dict, with and without difficulty bins, on cases
  whose JAX IoUs lie at least 1e-4 from the 0.5 and 0.7 thresholds (checked
  here), with tied scores among the predictions;
- ``eval/matched_iou.py``: matching, frame conversion, and the PPAL / CALD
  terms are exactly equal;
- ``data/datasets/nusc_eval.py::detections_to_nusc_boxes`` within 1e-6.

The port runs its IoUs on the CPU (``device="cpu"``); JAX's kitti_eval reads
its IoUs from one JAX call per metric (tests/jax_eval_ref.py)."""
import numpy as np
import pytest

from dal3d_tpu.data.datasets import nusc_eval as jne
from dal3d_tpu.eval import kitti_eval as jke
from dal3d_tpu.eval import matched_iou as jmi
from dal3d_tpu_torch.data.datasets import nusc_eval as tne
from dal3d_tpu_torch.eval import kitti_eval as tke
from dal3d_tpu_torch.eval import matched_iou as tmi
from jax_eval_ref import jax_ious, precomputed_jax_iou

CLASSES = ["car", "pedestrian", "barrier"]
SIZES = {"car": (1.97, 4.63, 1.74), "pedestrian": (0.67, 0.73, 1.77), "barrier": (2.53, 0.5, 0.98)}


def _frames(seed, n_frames=4, with_difficulty=False):
    """GT frames, and prediction frames made of jittered GT boxes (some
    mislabeled), duplicates and false positives, with tied scores."""
    rng = np.random.RandomState(seed)
    gts, preds = [], []
    for f in range(n_frames):
        n = rng.randint(3, 9)
        names = rng.choice(CLASSES, n)
        boxes = np.zeros((n, 9), np.float32)
        boxes[:, :2] = rng.uniform(-30, 30, (n, 2))
        boxes[:, 2] = rng.uniform(-1.5, -0.5, n)
        boxes[:, 3:6] = [SIZES[c] for c in names]
        boxes[:, 6:8] = rng.uniform(-2, 2, (n, 2))
        boxes[:, 8] = rng.uniform(-np.pi, np.pi, n)
        gt = {"boxes": boxes, "names": names}
        if with_difficulty:
            gt["difficulty"] = rng.randint(-1, 3, n).astype(np.int32)
        gts.append(gt)
        keep = rng.rand(n) < 0.8
        pb = boxes[keep].copy()
        pb[:, :2] += rng.normal(0, 0.3, (len(pb), 2))
        pb[:, 3:6] *= rng.uniform(0.85, 1.15, (len(pb), 3))
        pb[:, 8] += rng.normal(0, 0.1, len(pb))
        pn = names[keep].copy()
        flip = rng.rand(len(pn)) < 0.1
        pn[flip] = rng.choice(CLASSES, int(flip.sum()))
        dup = pb[: max(len(pb) // 3, 1)].copy()
        dup[:, :2] += rng.normal(0, 0.2, (len(dup), 2))
        fp = np.zeros((rng.randint(1, 4), 9), np.float32)
        fp[:, :2] = rng.uniform(-30, 30, (len(fp), 2))
        fp[:, 2] = -1.0
        fp[:, 3:6] = SIZES["car"]
        pb = np.concatenate([pb, dup, fp]).astype(np.float32)
        pn = np.concatenate([pn, pn[: len(dup)], np.array(["car"] * len(fp))])
        scores = np.round(rng.uniform(0.05, 1.0, len(pb)), 1).astype(np.float32)  # ties
        preds.append({"boxes": pb, "names": pn, "scores": scores})
    return gts, preds


SEEDS = {0: False, 1: False, 2: True, 3: True}


@pytest.fixture(scope="module")
def jax_ref():
    """The frames of every case, and JAX's IoUs of all their predictions
    against all their gt boxes (one JAX call per metric for the module)."""
    frames = {seed: _frames(seed, with_difficulty=bins) for seed, bins in SEEDS.items()}
    gts = [g for seed in SEEDS for g in frames[seed][0]]
    preds = [p for seed in SEEDS for p in frames[seed][1]]
    return frames, jax_ious(preds, gts)


def _margin_ok(gts, preds, ious):
    """Every prediction / gt pair of one class and frame, on JAX's IoUs, lies
    at least 1e-4 from both thresholds."""
    p, g, bev, iou3d = ious
    for gt, pred in zip(gts, preds):
        same = np.asarray(pred["names"])[:, None] == np.asarray(gt["names"])[None, :]
        rows = np.flatnonzero((p[:, None] == pred["boxes"][None]).all(-1).any(1))
        cols = np.flatnonzero((g[:, None] == gt["boxes"][None]).all(-1).any(1))
        for m in (bev, iou3d):
            blk = m[np.ix_(rows, cols)][same]
            if len(blk) and np.min(np.abs(blk[:, None] - np.array([0.5, 0.7])[None])) < 1e-4:
                return False
    return True


@pytest.mark.parametrize("seed", sorted(SEEDS))
def test_kitti_eval_equals_jax(jax_ref, seed):
    frames, ious = jax_ref
    gts, preds = frames[seed]
    bins = SEEDS[seed]
    assert _margin_ok(gts, preds, ious)
    with precomputed_jax_iou(*ious):
        ref = jke.kitti_eval(gts, preds, CLASSES)
    got = tke.kitti_eval(gts, preds, CLASSES, device="cpu")
    assert set(got["results"]) == set(ref["results"])
    assert ("mAP_bev_moderate" in ref["results"]) == bins
    assert got == ref
    assert 0.0 < ref["results"]["mAP_bev"] < 1.0


def test_kitti_eval_ious_agree_with_jax(jax_ref):
    """The matrices the port's matching reads, against JAX's, on boxes up to
    30 m from the origin. JAX's f32 shoelace sum of absolute coordinates
    rounds terms of |x|^2: against a float64 clip it errs by 1.4e-5 at +-30
    m and 1.3e-4 at +-50 m, where the port (each pair clipped in a frame
    centred on its first box) stays under 3e-7; within +-8 m both stay
    under 1e-6 (tests/test_torch_rotated_iou.py holds them at 1e-5). Hence
    the cases' 1e-4 margin from the thresholds."""
    p, g, bev, iou3d = jax_ref[1]
    np.testing.assert_allclose(tke._bev_iou(p, g, device="cpu"), bev, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tke._3d_iou(p, g, device="cpu"), iou3d, atol=1e-4, rtol=0)
    assert tke._bev_iou(p[:0], g, device="cpu").shape == (0, len(g))


def test_compute_difficulty_equals_jax():
    rng = np.random.RandomState(6)
    bbox = np.sort(rng.uniform(0, 100, (50, 4)), axis=1)[:, [0, 1, 2, 3]]
    occ, tr = rng.randint(0, 4, 50), rng.uniform(0, 0.6, 50)
    np.testing.assert_array_equal(tke.compute_difficulty(bbox, occ, tr),
                                  jke.compute_difficulty(bbox, occ, tr))


def _dets(seed, tokens, n=20):
    rng = np.random.RandomState(seed)
    out = {}
    for tok in tokens:
        b = np.zeros((n, 9), np.float32)
        b[:, :2] = rng.uniform(-45, 45, (n, 2))
        b[:, 2] = rng.uniform(-2, 0, n)
        b[:, 3:6] = rng.uniform(0.4, 5, (n, 3))
        b[:, 6:8] = rng.uniform(-3, 3, (n, 2))
        b[:, 8] = rng.uniform(-np.pi, np.pi, n)
        out[tok] = {"box3d_lidar": b, "scores": rng.uniform(0, 1, n).astype(np.float32),
                    "label_preds": rng.randint(0, 10, n).astype(np.int32),
                    "det_valid": rng.rand(n) < 0.7}
    return out


NUSC = ["car", "truck", "construction_vehicle", "bus", "trailer", "barrier", "motorcycle",
        "bicycle", "pedestrian", "traffic_cone"]


def _infos(seed, tokens):
    rng = np.random.RandomState(seed)
    infos = []
    for tok in tokens:
        n = rng.randint(0, 15)
        b = np.zeros((n, 9), np.float32)
        b[:, :2] = rng.uniform(-45, 45, (n, 2))
        b[:, 3:6] = rng.uniform(0.4, 5, (n, 3))
        rfc = np.eye(4)
        rfc[:3, 3] = rng.uniform(-1, 1, 3)
        infos.append({"token": tok, "gt_boxes": b, "gt_names": rng.choice(NUSC, n),
                      "ref_from_car": rfc})
    return infos


def _near(dets, infos, seed):
    """Moves the first detections of each frame onto its gt boxes (jittered
    by up to 1.5 m), so that the matching finds pairs."""
    rng = np.random.RandomState(seed)
    for info in infos:
        d, n = dets[info["token"]], min(len(info["gt_boxes"]), 20)
        d["box3d_lidar"][:n] = info["gt_boxes"][:n] + rng.uniform(-1.5, 1.5, (n, 9)).astype(
            np.float32) * np.array([1, 1, 0, 0.1, 0.1, 0.1, 0, 0, 0.2], np.float32)
        d["label_preds"][:n] = [NUSC.index(c) for c in info["gt_names"][:n]]
    return dets


def test_matched_iou_equals_jax():
    tokens = [f"tok{i}" for i in range(6)]
    infos = _infos(8, tokens)
    dets = _near(_dets(7, tokens), infos, 12)
    pf_t, pf_j = tmi.detections_to_frames(dets, NUSC), jmi.detections_to_frames(dets, NUSC)
    gf_t, gf_j = tmi.infos_to_frames(infos), jmi.infos_to_frames(infos)
    for a, b in ((pf_t, pf_j), (gf_t, gf_j)):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].keys() == b[k].keys()
            for f in a[k]:
                np.testing.assert_array_equal(a[k][f], b[k][f])
    # GT as reference (PPAL) and a second prediction set as reference (CALD)
    dets2 = _near(_dets(9, tokens), infos, 13)
    ref2_t = tmi.detections_to_frames(dets2, NUSC)
    for ref_t, ref_j in ((gf_t, gf_j), (ref2_t, jmi.detections_to_frames(dets2, NUSC))):
        got = tmi.accumulate_matches(ref_t, pf_t, NUSC, dist_th=4.0)
        want = jmi.accumulate_matches(ref_j, pf_j, NUSC, dist_th=4.0)
        assert got == want and sum(len(v["name"]) for v in got.values()) > 0
    d = tmi.accumulate_matches(ref2_t, pf_t, NUSC, dist_th=4.0)
    assert tmi.ppal_difficulty_weights(d) == jmi.ppal_difficulty_weights(d)
    assert (tmi.ppal_difficulty_weights(d, tokens[:3])
            == jmi.ppal_difficulty_weights(d, tokens[:3]))
    assert tmi.cald_consistency(d, tokens + ["none"]) == jmi.cald_consistency(d, tokens + ["none"])
    assert (tmi.class_distribution_jsdiv(d, tokens + ["none"], NUSC)
            == jmi.class_distribution_jsdiv(d, tokens + ["none"], NUSC))
    assert tmi.scale_iou([1, 2, 3], [2, 2, 2]) == jmi.scale_iou([1, 2, 3], [2, 2, 2])


def test_detections_to_nusc_boxes_within_1e6():
    tokens = [f"tok{i}" for i in range(3)]
    dets = _dets(10, tokens)
    rng = np.random.RandomState(11)
    for tok in tokens:
        info = {"token": tok}
        for key in ("ref_from_car", "car_from_global"):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            w, x, y, z = q
            m = np.eye(4)
            m[:3, :3] = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                         [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                         [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
            m[:3, 3] = rng.uniform(-500, 500, 3)
            info[key] = m
        got = tne.detections_to_nusc_boxes(dets[tok], info, NUSC)
        want = jne.detections_to_nusc_boxes(dets[tok], info, NUSC)
        assert len(got) == len(want) == int(dets[tok]["det_valid"].sum())
        for g, w in zip(got, want):
            for k in ("sample_token", "detection_name", "attribute_name"):
                assert g[k] == w[k]
            for k in ("translation", "size", "rotation", "velocity"):
                np.testing.assert_allclose(g[k], w[k], atol=1e-6, rtol=0)
            assert abs(g["detection_score"] - w["detection_score"]) <= 1e-6


def test_kitti_eval_without_device_needs_a_gpu(monkeypatch):
    import torch

    gts, preds = _frames(0, n_frames=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tke.kitti_eval(gts, preds, CLASSES)
