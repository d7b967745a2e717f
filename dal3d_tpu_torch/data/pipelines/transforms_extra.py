"""The other mmdet3d pipeline stages (port of
``dal3d_tpu/data/pipelines/transforms_extra.py``; host numpy, as there).

Stages of the reference's ``bevfusion/mmdet3d/datasets/pipelines/
transforms_3d.py``, each under the name ``build_pipeline`` maps to it:

- FrameDropout            — drop whole prior sweeps by their time offset
  (the current sweep, offset 0, is always kept)
- PointSample             — random subsample to a fixed count, with an
  optional near / far split (``sample_range``)
- BackgroundPointsFilter  — drop background points in the enlarged shell
  around each GT box
- VoxelBasedPointSampler  — voxelize current / previous sweeps apart and
  keep at most max_num_points per voxel
- ImagePad                — bottom / right pad to a size or a divisor
- ImageDistort            — photometric distortion (also under the name
  ``PhotoMetricDistortionMultiViewImage``)
- GlobalRotScaleTrans     — scene rotation / scale / normal translation,
  the aug matrix recorded for the camera branch
- RandomFlip3D            — independent x / y flips of points, boxes and
  the BEV seg masks
- ObjectPaste             — GT-AUG paste that removes the scene points in
  the sampled boxes, with ``stop_epoch``
- ObjectNoise             — per-object jitter (``augment.noise_per_object``)
- PointShuffle, ObjectRangeFilter, PointsRangeFilter, ObjectNameFilter

Every stage takes and returns ``(res, info)``, with points at
``res["lidar"]["points"]`` and images at ``res["camera"]["np_images"]``.
Annotation stages accept the loader's key set (``boxes`` / ``names`` / ...)
and the post-``Preprocess`` one (``gt_boxes`` / ``gt_names`` /
``gt_classes``) and keep every parallel per-box array aligned. The random
stages draw from their ``rng`` (a fresh ``np.random.RandomState`` unless
one is given) in the JAX module's order, so equal seeds give equal outputs
bit for bit.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ...core import box_np_ops
from ...core.voxel_generator import VoxelGenerator


class FrameDropout:
    """Randomly drop prior sweeps (distinct nonzero time offsets) whole."""

    def __init__(self, prob: float = 0.5, time_dim: int = -1,
                 rng: Optional[np.random.RandomState] = None):
        self.prob = prob
        self.time_dim = time_dim
        self.rng = rng or np.random.RandomState()

    def __call__(self, res: dict, info: dict):
        pts = res["lidar"]["points"]
        ts = pts[:, self.time_dim]
        keep_offsets = [o for o in np.unique(ts)
                        if o == 0 or self.rng.rand() > self.prob]
        res["lidar"]["points"] = pts[np.isin(ts, np.asarray(keep_offsets))]
        return res, info


class PointSample:
    """Subsample the cloud to ``num_points`` (with replacement only when the
    cloud is smaller). ``sample_range`` keeps all far points (depth > range,
    up to the budget) and samples the remainder from the near set."""

    def __init__(self, num_points: int, sample_range: Optional[float] = None,
                 replace: bool = False,
                 rng: Optional[np.random.RandomState] = None):
        self.num_points = num_points
        self.sample_range = sample_range
        self.replace = replace
        self.rng = rng or np.random.RandomState()

    def __call__(self, res: dict, info: dict):
        pts = res["lidar"]["points"]
        n = pts.shape[0]
        if n == 0:  # upstream filters can empty the cloud; nothing to sample
            return res, info
        replace = self.replace or n < self.num_points
        if self.sample_range is not None and not replace:
            depth = np.linalg.norm(pts[:, :3], axis=1)
            far = np.where(depth > self.sample_range)[0]
            near = np.where(depth <= self.sample_range)[0]
            if len(far) > self.num_points:
                far = self.rng.choice(far, self.num_points, replace=False)
            take = self.num_points - len(far)
            choice = np.concatenate(
                [far, self.rng.choice(near, take, replace=False)])
            self.rng.shuffle(choice)
        else:
            choice = self.rng.choice(n, self.num_points, replace=replace)
        res["lidar"]["points"] = pts[choice]
        return res, info


class BackgroundPointsFilter:
    """Drop points that fall inside GT boxes enlarged by
    ``bbox_enlarge_range`` but outside the original boxes (the ambiguous
    near-box shell)."""

    def __init__(self, bbox_enlarge_range):
        if isinstance(bbox_enlarge_range, (int, float)):
            bbox_enlarge_range = (float(bbox_enlarge_range),) * 3
        assert len(bbox_enlarge_range) == 3, bbox_enlarge_range
        # extra margin PER SIDE (mmdet3d transforms_3d.py BackgroundPointsFilter)
        self.enlarge = np.asarray(bbox_enlarge_range, np.float32)

    def __call__(self, res: dict, info: dict):
        pts = res["lidar"]["points"]
        boxes = np.asarray(res["lidar"]["annotations"]["gt_boxes"])
        if boxes.shape[0] == 0:
            return res, info
        big = boxes.copy()
        big[:, 3:6] = big[:, 3:6] + 2.0 * self.enlarge[None]
        # our box z is the BOTTOM face (points_in_rbbox origin (0.5,0.5,0)):
        # shift it down so the enlarged box extends below the object too
        big[:, 2] = big[:, 2] - self.enlarge[2]
        fg = box_np_ops.points_in_rbbox(pts, boxes).any(-1)
        fg_big = box_np_ops.points_in_rbbox(pts, big).any(-1)
        res["lidar"]["points"] = pts[~(fg_big & ~fg)]
        return res, info


class VoxelBasedPointSampler:
    """Voxel-sample current and previous sweeps separately: each sweep set is
    shuffled, voxelized with its own (voxel_size, range, max_num_points,
    max_voxels), and the surviving per-voxel points replace the cloud."""

    def __init__(self, cur_sweep_cfg: dict, prev_sweep_cfg: Optional[dict] = None,
                 time_dim: int = 4,  # [x,y,z,intensity,time] (loading.py)
                 rng: Optional[np.random.RandomState] = None):
        self.cur = VoxelGenerator(**cur_sweep_cfg)
        self.prev = VoxelGenerator(**prev_sweep_cfg) if prev_sweep_cfg else None
        if self.prev is not None:
            assert (prev_sweep_cfg["max_num_points"]
                    == cur_sweep_cfg["max_num_points"])
        self.time_dim = time_dim
        self.rng = rng or np.random.RandomState()

    def _sample(self, pts: np.ndarray, gen: VoxelGenerator) -> np.ndarray:
        voxels, _, npts = gen.generate(pts)
        keep = (np.arange(voxels.shape[1])[None, :] < npts[:, None])
        return voxels[keep]

    def __call__(self, res: dict, info: dict):
        pts = res["lidar"]["points"]
        cur_mask = pts[:, self.time_dim] == 0
        cur, prev = pts[cur_mask], pts[~cur_mask]
        self.rng.shuffle(cur)
        out = [self._sample(cur, self.cur)]
        if prev.shape[0] and self.prev is not None:
            self.rng.shuffle(prev)
            out.append(self._sample(prev, self.prev))
        elif prev.shape[0]:
            out.append(prev)
        res["lidar"]["points"] = np.concatenate(out, axis=0)
        return res, info


class ImagePad:
    """Pad images bottom/right to a fixed (h, w) or to a size divisor."""

    def __init__(self, size: Optional[Tuple[int, int]] = None,
                 size_divisor: Optional[int] = None, pad_val: float = 0.0):
        assert (size is None) != (size_divisor is None), \
            "exactly one of size / size_divisor"
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val

    def _pad(self, a: np.ndarray) -> np.ndarray:
        h, w = a.shape[:2]
        if self.size is not None:
            th, tw = self.size
        else:
            d = self.size_divisor
            th, tw = -(-h // d) * d, -(-w // d) * d
        assert th >= h and tw >= w, ((h, w), (th, tw))
        return np.pad(a, ((0, th - h), (0, tw - w)) + ((0, 0),) * (a.ndim - 2),
                      constant_values=self.pad_val)

    def __call__(self, res: dict, info: dict):
        cam = res["camera"]
        arrs = cam.get("np_images") or [np.asarray(i, np.float32)
                                        for i in cam["pil_images"]]
        cam["np_images"] = [self._pad(a) for a in arrs]
        return res, info


def _rgb_to_hsv(img: np.ndarray):
    """Vectorized RGB->HSV on float32 [0,255] images (H in degrees)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    mx = img.max(-1)
    mn = img.min(-1)
    d = mx - mn
    safe = np.where(d == 0, 1.0, d)
    h = np.where(mx == r, (g - b) / safe % 6.0,
                 np.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    h = np.where(d == 0, 0.0, h) * 60.0
    s = np.where(mx == 0, 0.0, d / np.where(mx == 0, 1.0, mx))
    return h, s, mx


def _hsv_to_rgb(h: np.ndarray, s: np.ndarray, v: np.ndarray) -> np.ndarray:
    h = (h % 360.0) / 60.0
    c = v * s
    x = c * (1.0 - np.abs(h % 2.0 - 1.0))
    m = v - c
    z = np.zeros_like(c)
    idx = h.astype(np.int64) % 6
    rgb = np.stack([
        np.choose(idx, [c, x, z, z, x, c]),
        np.choose(idx, [x, c, c, x, z, z]),
        np.choose(idx, [z, z, x, c, c, x]),
    ], axis=-1)
    return rgb + m[..., None]


class ImageDistort:
    """Photometric distortion, each sub-op applied with probability 0.5:
    brightness shift, contrast scale (before or after the HSV ops), HSV
    saturation scale + hue shift, random channel swap. Operates on float32
    RGB images in [0, 255] (pre-normalize)."""

    def __init__(self, brightness_delta: float = 32.0,
                 contrast_range: Tuple[float, float] = (0.5, 1.5),
                 saturation_range: Tuple[float, float] = (0.5, 1.5),
                 hue_delta: float = 18.0,
                 rng: Optional[np.random.RandomState] = None):
        self.brightness_delta = brightness_delta
        self.contrast_range = contrast_range
        self.saturation_range = saturation_range
        self.hue_delta = hue_delta
        self.rng = rng or np.random.RandomState()

    def _one(self, img: np.ndarray) -> np.ndarray:
        rng = self.rng
        if rng.randint(2):
            img = img + rng.uniform(-self.brightness_delta,
                                    self.brightness_delta)
        contrast_first = bool(rng.randint(2))
        if contrast_first and rng.randint(2):
            img = img * rng.uniform(*self.contrast_range)
        do_sat, do_hue = bool(rng.randint(2)), bool(rng.randint(2))
        if do_sat or do_hue:
            h, s, v = _rgb_to_hsv(np.clip(img, 0, 255))
            if do_sat:
                s = np.clip(s * rng.uniform(*self.saturation_range), 0, 1)
            if do_hue:
                h = h + rng.uniform(-self.hue_delta, self.hue_delta)
            img = _hsv_to_rgb(h, s, v)
        if not contrast_first and rng.randint(2):
            img = img * rng.uniform(*self.contrast_range)
        if rng.randint(2):
            img = img[..., rng.permutation(3)]
        return np.clip(img, 0, 255).astype(np.float32)

    def __call__(self, res: dict, info: dict):
        if res.get("mode") != "train":
            return res, info
        cam = res["camera"]
        arrs = cam.get("np_images") or [np.asarray(i, np.float32)
                                        for i in cam["pil_images"]]
        cam["np_images"] = [self._one(a) for a in arrs]
        return res, info


# ---------------------------------------------------------------------------
# annotation-dict helpers: stages below work both before Preprocess (loader
# keys: boxes/names/tokens/velocities) and after it (gt_boxes/gt_names/
# gt_classes), editing every parallel per-box array consistently.
# ---------------------------------------------------------------------------

_BOX_KEY_SETS = (("gt_boxes", ("gt_names", "gt_classes")),
                 ("boxes", ("names", "tokens", "velocities")))


def _anno(res: dict) -> Optional[dict]:
    return res.get("lidar", {}).get("annotations")


def _anno_boxes(anno: dict):
    """(box_key, boxes [N,>=7] float) for either annotation key set."""
    for key, _ in _BOX_KEY_SETS:
        if key in anno:
            return key, np.asarray(anno[key], np.float32)
    raise KeyError(f"no box array in annotations: {sorted(anno)}")


def _anno_select(anno: dict, mask: np.ndarray) -> None:
    """Filter the box array and every parallel per-box array by ``mask``."""
    for key, parallels in _BOX_KEY_SETS:
        if key not in anno:
            continue
        n = len(np.asarray(anno[key]))
        anno[key] = np.asarray(anno[key])[mask]
        for p in parallels:
            if p in anno and len(np.asarray(anno[p])) == n:
                anno[p] = np.asarray(anno[p])[mask]
        return
    raise KeyError(f"no box array in annotations: {sorted(anno)}")


class GlobalRotScaleTrans:
    """Scene-level rotation / scaling / translation (mmdet3d
    transforms_3d.py:124). Train-only; composes the flip-free lidar aug
    matrix ``res["lidar"]["aug_matrix"]`` (3x3, row-vector convention, same
    as Preprocess) so the camera branch keeps its extrinsics consistent.

    rot_lim/resize_lim are (lo, hi); trans_lim is the per-axis std of the
    normal translation noise (mmdet3d uses a scalar std for all 3 axes)."""

    def __init__(self, resize_lim=(0.95, 1.05), rot_lim=(-0.3925, 0.3925),
                 trans_lim: float = 0.0,
                 rng: Optional[np.random.RandomState] = None, **kwargs):
        self.resize_lim = tuple(resize_lim)
        self.rot_lim = tuple(rot_lim)
        self.trans_lim = float(trans_lim)
        self.rng = rng or np.random.RandomState()

    def __call__(self, res: dict, info: dict):
        if res.get("mode") not in (None, "train"):
            return res, info
        from . import augment

        anno = _anno(res)
        pts = res["lidar"]["points"]
        key, boxes = (None, np.zeros((0, 9), np.float32))
        if anno is not None:
            key, boxes = _anno_boxes(anno)
        rec: dict = {}
        boxes, pts = augment.global_rotation(boxes, pts, rotation=self.rot_lim,
                                             rng=self.rng, record=rec)
        if self.trans_lim > 0:
            t = self.rng.normal(0.0, self.trans_lim, size=3)
            pts[:, :3] += t
            boxes[:, :3] += t
            rec["translation"] = t
        boxes, pts = augment.global_scaling_v2(boxes, pts, *self.resize_lim,
                                               rng=self.rng, record=rec)
        if anno is not None:
            anno[key] = boxes
        res["lidar"]["points"] = pts
        ang = rec.get("rotation", 0.0)
        c, s = np.cos(ang), np.sin(ang)
        A = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
        A = rec.get("scale", 1.0) * A
        prev = res["lidar"].get("aug_matrix")
        res["lidar"]["aug_matrix"] = (
            A @ prev if prev is not None else A).astype(np.float32)
        res["lidar"]["aug_translation"] = (
            rec.get("translation", np.zeros(3))
            * rec.get("scale", 1.0)).astype(np.float32)
        return res, info


class RandomFlip3D:
    """Independent 0.5-probability x and y flips of points / boxes / BEV seg
    masks (mmdet3d transforms_3d.py:247); composes the aug matrix."""

    def __init__(self, probability: float = 0.5,
                 rng: Optional[np.random.RandomState] = None, **kwargs):
        self.probability = probability
        self.rng = rng or np.random.RandomState()

    def __call__(self, res: dict, info: dict):
        if res.get("mode") not in (None, "train"):
            return res, info
        from . import augment

        anno = _anno(res)
        pts = res["lidar"]["points"]
        key, boxes = (None, np.zeros((0, 9), np.float32))
        if anno is not None:
            key, boxes = _anno_boxes(anno)
        rec: dict = {}
        boxes, pts = augment.random_flip_both(boxes, pts,
                                              probability=self.probability,
                                              rng=self.rng, record=rec)
        if anno is not None:
            anno[key] = boxes
        res["lidar"]["points"] = pts
        if "gt_masks_bev" in res:  # [C, Wc, Hc]: axis 1 follows x, axis 2 y
            m = res["gt_masks_bev"]
            if rec.get("flip_y"):
                m = m[:, :, ::-1]
            if rec.get("flip_x"):
                m = m[:, ::-1, :]
            res["gt_masks_bev"] = np.ascontiguousarray(m)
        A = np.eye(3)
        if rec.get("flip_y"):
            A = np.diag([1.0, -1.0, 1.0]) @ A
        if rec.get("flip_x"):
            A = np.diag([-1.0, 1.0, 1.0]) @ A
        prev = res["lidar"].get("aug_matrix")
        res["lidar"]["aug_matrix"] = (
            A @ prev if prev is not None else A).astype(np.float32)
        return res, info


class ObjectPaste:
    """Standalone GT-AUG paste (mmdet3d transforms_3d.py:276): sample boxes
    from the database, REMOVE scene points inside the sampled boxes (the
    mmdet3d semantics; det3d's Preprocess paste keeps them), and prepend the
    sampled object points. ``stop_epoch`` disables pasting from that epoch on
    (set via set_epoch, mirroring mmdet3d's fade-aug schedule)."""

    def __init__(self, db_sampler: dict, sample_2d: bool = False,
                 stop_epoch: Optional[int] = None, **kwargs):
        from ..sampler import DataBaseSamplerV2, build_db_preprocessors

        db_cfg = dict(db_sampler)
        prep = build_db_preprocessors(db_cfg.get("db_prep_steps", []))
        try:
            self.db_sampler = DataBaseSamplerV2(
                db_cfg["db_info_path"],
                [dict(g) for g in db_cfg.get("sample_groups", [])],
                db_prepor=prep,
                rate=db_cfg.get("rate", 1.0),
            )
        except FileNotFoundError:
            self.db_sampler = None
        self.sample_2d = sample_2d
        self.stop_epoch = stop_epoch
        self.epoch = -1

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __call__(self, res: dict, info: dict):
        if res.get("mode") not in (None, "train") or self.db_sampler is None:
            return res, info
        if self.stop_epoch is not None and self.epoch >= self.stop_epoch:
            return res, info
        anno = _anno(res)
        if anno is None:
            return res, info
        key, boxes = _anno_boxes(anno)
        names_key = "gt_names" if key == "gt_boxes" else "names"
        names = np.asarray(anno[names_key])
        pts = res["lidar"]["points"]
        sampled = self.db_sampler.sample_all(
            res.get("metadata", {}).get("image_prefix", ""),
            boxes, names, num_point_features=pts.shape[1],
        )
        if sampled is None:
            return res, info
        sb = np.asarray(sampled["gt_boxes"], np.float32)
        if sb.shape[1] < boxes.shape[1]:
            sb = np.hstack([sb[:, :-1],
                            np.zeros((len(sb), boxes.shape[1] - sb.shape[1]),
                                     np.float32), sb[:, -1:]])
        anno[key] = np.concatenate([boxes, sb[:, :boxes.shape[1]]])
        anno[names_key] = np.concatenate([names, sampled["gt_names"]])
        if key == "boxes":  # keep the loader's parallel arrays aligned
            ns = len(sampled["gt_names"])
            if "tokens" in anno:
                anno["tokens"] = np.concatenate(
                    [np.asarray(anno["tokens"]), np.asarray([""] * ns)])
            if "velocities" in anno:
                anno["velocities"] = np.concatenate(
                    [np.asarray(anno["velocities"], np.float32),
                     np.zeros((ns, 3), np.float32)])
        elif "gt_classes" in anno:
            # classes must be re-derived by the caller; drop to stay honest
            anno.pop("gt_classes")
        inside = box_np_ops.points_in_rbbox(pts, sb[:, [0, 1, 2, 3, 4, 5, -1]]
                                            if sb.shape[1] > 7 else sb)
        pts = pts[~inside.any(-1)]
        sp = np.asarray(sampled["points"], np.float32)
        if sp.shape[1] < pts.shape[1]:
            sp = np.hstack([sp, np.zeros((len(sp), pts.shape[1] - sp.shape[1]),
                                         sp.dtype)])
        res["lidar"]["points"] = np.concatenate([sp, pts], axis=0)
        return res, info


class ObjectNoise:
    """Per-object pose jitter (mmdet3d transforms_3d.py:372); wraps
    augment.noise_per_object (full collision-tested candidate semantics)."""

    def __init__(self, translation_std=(0.25, 0.25, 0.25),
                 global_rot_range=(0.0, 0.0),
                 rot_range=(-0.15707963267, 0.15707963267),
                 num_try: int = 100,
                 rng: Optional[np.random.RandomState] = None, **kwargs):
        assert tuple(global_rot_range) == (0.0, 0.0), \
            "global_rot_range is unused by every shipped config"
        self.translation_std = tuple(translation_std)
        self.rot_range = tuple(rot_range)
        self.num_try = num_try
        self.rng = rng or np.random.RandomState()

    def __call__(self, res: dict, info: dict):
        if res.get("mode") not in (None, "train"):
            return res, info
        from . import augment

        anno = _anno(res)
        if anno is None:
            return res, info
        key, boxes = _anno_boxes(anno)
        pts = res["lidar"]["points"]
        augment.noise_per_object(boxes, pts,
                                 rotation_perturb=self.rot_range,
                                 center_noise_std=self.translation_std,
                                 num_try=self.num_try, rng=self.rng)
        anno[key] = boxes
        res["lidar"]["points"] = pts
        return res, info


class PointShuffle:
    def __init__(self, rng: Optional[np.random.RandomState] = None, **kwargs):
        self.rng = rng or np.random.RandomState()

    def __call__(self, res: dict, info: dict):
        self.rng.shuffle(res["lidar"]["points"])
        return res, info


class ObjectRangeFilter:
    """Keep boxes whose BEV center lies in [x0,y0,x3,y4] and limit yaw to
    [-pi, pi) (mmdet3d transforms_3d.py:454)."""

    def __init__(self, point_cloud_range, **kwargs):
        self.pcd_range = np.asarray(point_cloud_range, np.float32)

    def __call__(self, res: dict, info: dict):
        anno = _anno(res)
        if anno is None:
            return res, info
        key, boxes = _anno_boxes(anno)
        bev = self.pcd_range[[0, 1, 3, 4]]
        mask = ((boxes[:, 0] >= bev[0]) & (boxes[:, 0] < bev[2])
                & (boxes[:, 1] >= bev[1]) & (boxes[:, 1] < bev[3]))
        _anno_select(anno, mask)
        _, boxes = _anno_boxes(anno)
        if len(boxes):
            boxes[:, -1] = box_np_ops.limit_period(
                boxes[:, -1], offset=0.5, period=2 * np.pi)
            anno[key] = boxes
        return res, info


class PointsRangeFilter:
    """Keep points inside the 3D point-cloud range (transforms_3d.py:504)."""

    def __init__(self, point_cloud_range, **kwargs):
        self.pcd_range = np.asarray(point_cloud_range, np.float32)

    def __call__(self, res: dict, info: dict):
        pts = res["lidar"]["points"]
        r = self.pcd_range
        mask = ((pts[:, 0] >= r[0]) & (pts[:, 0] < r[3])
                & (pts[:, 1] >= r[1]) & (pts[:, 1] < r[4])
                & (pts[:, 2] >= r[2]) & (pts[:, 2] < r[5]))
        res["lidar"]["points"] = pts[mask]
        return res, info


class ObjectNameFilter:
    """Keep boxes whose class name is in ``classes`` (transforms_3d.py:529;
    the reference filters by label id — names are this package's labels)."""

    def __init__(self, classes: Sequence[str], **kwargs):
        self.classes = list(classes)

    def __call__(self, res: dict, info: dict):
        anno = _anno(res)
        if anno is None:
            return res, info
        key, _ = _anno_boxes(anno)
        names_key = "gt_names" if key == "gt_boxes" else "names"
        names = np.asarray(anno[names_key])
        mask = np.array([n in self.classes for n in names], bool)
        _anno_select(anno, mask)
        return res, info
