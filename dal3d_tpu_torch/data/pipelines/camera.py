"""Multi-view camera pipeline of BEVFusion's camera branch, host side (port
of ``dal3d_tpu/data/pipelines/camera.py``: the same stages, the same PIL
calls, the same numpy, so the same frames and seeds give the same arrays).

- ``LoadMultiViewImages``: reads ``info["cams"][name]``: data_path,
  camera_intrinsics [3, 3], sensor2lidar_rotation [3, 3],
  sensor2lidar_translation [3];
- ``ImageAug3D``: resize -> bottom crop -> optional horizontal flip -> small
  rotation (PIL's ``resize`` (BICUBIC on RGB), ``crop`` (zero fill outside),
  ``transpose`` and ``rotate`` (NEAREST, fill 0)), tracking the pixel
  affine ``aug_pixel = R @ orig_pixel + t`` that the view transform undoes;
  train mode samples the ranges, val takes their midpoints and a centred
  crop;
- ``GridMask``: stripe-grid occlusion (a training regulariser);
- ``ImageNormalize``: (img / 255 - mean) / std;
- ``rasterize_depth`` / ``ReformatCamera``: the fixed-shape camera keys of
  the batch (images [N, fH, fW, 3] f32, camera_intrinsics /
  camera2lidar_rots / img_aug_rots [N, 3, 3], camera2lidar_trans /
  img_aug_trans [N, 3], depth_images [N, fH, fW, 1]: the lidar points
  projected into each camera, the nearest depth per pixel), with the lidar
  augmentation (``res["lidar"]["aug_matrix"]``) folded into the extrinsics.

PIL is imported inside the stages that use it (decoding, the augmentation,
GridMask's rotation), as the JAX package does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_CAMS = (
    "CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
    "CAM_BACK_LEFT", "CAM_BACK", "CAM_BACK_RIGHT",
)


def _open_image(path: str):
    from PIL import Image

    return Image.open(path).convert("RGB")


class LoadMultiViewImages:
    def __init__(self, cam_names: Sequence[str] = DEFAULT_CAMS):
        self.cam_names = list(cam_names)

    def __call__(self, res: dict, info: dict):
        cams = info["cams"]
        pil, K, R, t = [], [], [], []
        for name in self.cam_names:
            c = cams[name]
            pil.append(_open_image(c["data_path"]))
            K.append(np.asarray(c["camera_intrinsics"], np.float32))
            R.append(np.asarray(c["sensor2lidar_rotation"], np.float32))
            t.append(np.asarray(c["sensor2lidar_translation"], np.float32))
        n = len(pil)
        res["camera"] = {
            "pil_images": pil,
            "camera_intrinsics": np.stack(K),
            "camera2lidar_rots": np.stack(R),
            "camera2lidar_trans": np.stack(t),
            "aug_rots": [np.eye(2, dtype=np.float64) for _ in range(n)],
            "aug_trans": [np.zeros(2, np.float64) for _ in range(n)],
        }
        return res, info


class ImageAug3D:
    """Resize -> bottom-crop -> optional hflip -> small rotation, tracking the
    pixel-space affine so the view transform can undo it on device."""

    def __init__(self, final_dim: Tuple[int, int], resize_lim: Tuple[float, float],
                 bot_pct_lim: Tuple[float, float] = (0.0, 0.0),
                 rot_lim: Tuple[float, float] = (0.0, 0.0),
                 rand_flip: bool = False, rng: Optional[np.random.RandomState] = None):
        self.final_dim = tuple(final_dim)  # (fH, fW)
        self.resize_lim = resize_lim
        self.bot_pct_lim = bot_pct_lim
        self.rot_lim = rot_lim
        self.rand_flip = rand_flip
        self.rng = rng or np.random.RandomState()

    def _sample(self, W: int, H: int, train: bool):
        fH, fW = self.final_dim
        if train:
            resize = float(self.rng.uniform(*self.resize_lim))
            newW, newH = int(W * resize), int(H * resize)
            crop_h = int((1 - self.rng.uniform(*self.bot_pct_lim)) * newH) - fH
            crop_w = int(self.rng.uniform(0, max(0, newW - fW)))
            flip = bool(self.rand_flip and self.rng.randint(2))
            rotate = float(self.rng.uniform(*self.rot_lim))
        else:
            resize = float(np.mean(self.resize_lim))
            newW, newH = int(W * resize), int(H * resize)
            crop_h = int((1 - np.mean(self.bot_pct_lim)) * newH) - fH
            crop_w = int(max(0, newW - fW) / 2)
            flip, rotate = False, 0.0
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        return resize, (newW, newH), crop, flip, rotate

    def _apply(self, img, R, t, resize, resize_dims, crop, flip, rotate):
        from PIL import Image

        fH, fW = self.final_dim
        img = img.resize(resize_dims)
        img = img.crop(crop)
        R = R * resize
        t = t * resize
        t = t - np.asarray(crop[:2], np.float64)
        if flip:
            img = img.transpose(method=Image.FLIP_LEFT_RIGHT)
            A = np.array([[-1.0, 0.0], [0.0, 1.0]])
            b = np.array([float(fW), 0.0])
            R = A @ R
            t = A @ t + b
        if rotate:
            # PIL rotate(a) turns the IMAGE counterclockwise by a degrees
            # about its center, i.e. pixel coords rotate clockwise by a.
            img = img.rotate(rotate)
            th = np.deg2rad(rotate)
            A = np.array([[np.cos(th), np.sin(th)], [-np.sin(th), np.cos(th)]])
            c = np.array([fW / 2.0, fH / 2.0])
            b = c - A @ c
            R = A @ R
            t = A @ t + b
        return img, R, t

    def __call__(self, res: dict, info: dict):
        cam = res["camera"]
        train = res.get("mode") == "train"
        out_imgs, out_R, out_t = [], [], []
        for img, R, t in zip(cam["pil_images"], cam["aug_rots"], cam["aug_trans"]):
            W, H = img.size
            params = self._sample(W, H, train)
            img, R, t = self._apply(img, R, t, *params)
            out_imgs.append(img)
            out_R.append(R)
            out_t.append(t)
        cam["pil_images"], cam["aug_rots"], cam["aug_trans"] = out_imgs, out_R, out_t
        return res, info


class GridMask:
    """Stripe-grid occlusion on the stacked images (training regularizer)."""

    def __init__(self, prob: float = 0.0, ratio: float = 0.5, rotate: int = 1,
                 use_h: bool = True, use_w: bool = True, mode: int = 1,
                 rng: Optional[np.random.RandomState] = None):
        self.prob = prob
        self.ratio = ratio
        self.rotate = rotate
        self.use_h = use_h
        self.use_w = use_w
        self.mode = mode
        self.rng = rng or np.random.RandomState()

    def _mask(self, h: int, w: int) -> np.ndarray:
        d = int(self.rng.randint(2, min(h, w)))
        keep = min(max(int(d * self.ratio + 0.5), 1), d - 1)
        hh, ww = int(1.5 * h), int(1.5 * w)
        mask = np.ones((hh, ww), np.float32)
        sh, sw = int(self.rng.randint(d)), int(self.rng.randint(d))
        if self.use_h:
            for i in range(hh // d + 1):
                s = d * i + sh
                mask[s: min(s + keep, hh), :] = 0
        if self.use_w:
            for i in range(ww // d + 1):
                s = d * i + sw
                mask[:, s: min(s + keep, ww)] = 0
        if self.rotate > 1:
            from PIL import Image

            r = int(self.rng.randint(self.rotate))
            mask = np.asarray(Image.fromarray((mask * 255).astype(np.uint8)).rotate(r),
                              np.float32) / 255.0
        y0, x0 = (hh - h) // 2, (ww - w) // 2
        mask = mask[y0: y0 + h, x0: x0 + w]
        return 1.0 - mask if self.mode == 1 else mask

    def __call__(self, res: dict, info: dict):
        if res.get("mode") != "train" or self.rng.rand() > self.prob:
            return res, info
        cam = res["camera"]
        out = []
        for img in cam["pil_images"]:
            a = np.asarray(img, np.float32)
            m = self._mask(a.shape[0], a.shape[1])[..., None]
            out.append(a * m)
        cam["np_images"] = out  # downstream stages prefer arrays once masked
        return res, info


class ImageNormalize:
    def __init__(self, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, res: dict, info: dict):
        cam = res["camera"]
        arrs = cam.get("np_images") or [np.asarray(i, np.float32) for i in cam["pil_images"]]
        cam["np_images"] = [((a / 255.0) - self.mean) / self.std for a in arrs]
        return res, info


def rasterize_depth(points_xyz: np.ndarray, K: np.ndarray, c2l_rot: np.ndarray,
                    c2l_trans: np.ndarray, aug_rot: np.ndarray, aug_trans: np.ndarray,
                    fH: int, fW: int) -> np.ndarray:
    """Project lidar points into one camera and keep the nearest depth per
    pixel (host twin of the reference's on-GPU scatter, vtransforms/base.py:
    128-158)."""
    # R^{-1} (p - t) in row-vector form; c2l_rot may carry folded-in lidar
    # aug (scale/flip), so use the true inverse rather than the transpose
    p_cam = (points_xyz - c2l_trans[None]) @ np.linalg.inv(c2l_rot).T
    z = p_cam[:, 2]
    ok = z > 1e-3
    pix = (p_cam[ok] @ K.T)
    pix = pix[:, :2] / pix[:, 2:3]
    pix = pix @ aug_rot[:2, :2].T + aug_trans[None, :2]
    u = np.round(pix[:, 0]).astype(np.int64)
    v = np.round(pix[:, 1]).astype(np.int64)
    zz = z[ok]
    inb = (u >= 0) & (u < fW) & (v >= 0) & (v < fH)
    depth = np.full((fH * fW,), 0.0, np.float32)
    lin = v[inb] * fW + u[inb]
    order = np.argsort(-zz[inb])  # nearest written last wins
    depth[lin[order]] = zz[inb][order]
    return depth.reshape(fH, fW, 1)


class ReformatCamera:
    """Stack per-camera data into the fixed-shape batch keys BEVFusion's
    camera branch consumes; rasterize the lidar depth maps."""

    def __init__(self, final_dim: Tuple[int, int], with_depth: bool = True):
        self.final_dim = tuple(final_dim)
        self.with_depth = with_depth

    def __call__(self, res: dict, info: dict):
        cam = res["camera"]
        fH, fW = self.final_dim
        arrs = cam.get("np_images") or [np.asarray(i, np.float32) for i in cam["pil_images"]]
        images = np.stack([a[:fH, :fW].astype(np.float32) for a in arrs])
        n = images.shape[0]
        aug_rots = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
        aug_trans = np.zeros((n, 3), np.float32)
        for i, (R, t) in enumerate(zip(cam["aug_rots"], cam["aug_trans"])):
            aug_rots[i, :2, :2] = R
            aug_trans[i, :2] = t
        # fold the lidar-frame augmentation (flip/rot/scale from Preprocess)
        # into the extrinsics: p_lidar_aug = A (R p_cam + t)
        c2l_r = cam["camera2lidar_rots"].astype(np.float32)
        c2l_t = cam["camera2lidar_trans"].astype(np.float32)
        A = res.get("lidar", {}).get("aug_matrix")
        if A is not None:
            c2l_r = np.einsum("ij,njk->nik", A, c2l_r)
            c2l_t = c2l_t @ A.T
        out = {
            "images": images,
            "camera_intrinsics": cam["camera_intrinsics"].astype(np.float32),
            "camera2lidar_rots": c2l_r,
            "camera2lidar_trans": c2l_t,
            "img_aug_rots": aug_rots,
            "img_aug_trans": aug_trans,
        }
        if self.with_depth:
            pts = res["lidar"]["points"][:, :3]
            out["depth_images"] = np.stack([
                rasterize_depth(pts, out["camera_intrinsics"][i],
                                out["camera2lidar_rots"][i], out["camera2lidar_trans"][i],
                                aug_rots[i], aug_trans[i], fH, fW)
                for i in range(n)
            ])
        cam["batch"] = out
        return res, info
