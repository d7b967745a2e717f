"""BEVFusion train and predict steps (port of
``dal3d_tpu/runtime/bevfusion_steps.py``).

Batch contract (leading dim B): host voxels ``voxel_features`` [B, N, F],
``voxel_coords`` [B, N, 3] int (z, y, x), ``voxel_valid`` [B, N] (numpy
arrays or tensors), as the dataset's ``ReformatFixedShape`` with
``voxelize_host`` makes them; or, without them, raw ``points`` [B, P, F] and
``points_valid`` [B, P], voxelized on the device at the config's grid
(``ops/voxelize.py::voxelize_mean_grid``). A model with the camera branch
also takes the ``CAMERA_KEYS`` of ``ReformatCamera``: images [B, Nc, iH,
iW, 3], depth_images [B, Nc, iH, iW, 1], camera2lidar_rots / trans,
camera_intrinsics, img_aug_rots / trans (a lidar-only model ignores them).
The train step also takes ``gt_boxes`` [B, G, 9] (lidar frame) and
``gt_classes`` [B, G] global 1-based classes (0 = padding), and for a model
with map segmentation ``gt_masks_bev`` [B, Hc, Wc, C] (``LoadBEVSegmentation``
through ``ReformatFixedShape``); none of the three is a model input.

The steps serve the TransFusion head. JAX's steps have no CenterPoint path
(its CLI builds TransFusion whatever the config's ``head``), so both makers
refuse a CenterPoint model (ROADMAP C.4); its decode and loss are
``models/bevfusion/centerpoint.py``'s.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from ..models.bevfusion.bevfusion import CAMERA_TRANSFORMS
from ..models.bevfusion.second import AddFuser
from ..models.bevfusion.segm import bev_segmentation_loss
from ..models.bevfusion.swin import DropPath
from ..models.bevfusion.transfusion import Dropout, transfusion_decode, transfusion_loss
from ..ops.resize import resize_bilinear
from .steps import _full_f32, _to_device, autotuned_convs, model_inputs

CAMERA_KEYS = ("images", "depth_images") + CAMERA_TRANSFORMS


def bevfusion_inputs(model, batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The model's inputs from a batch: ``steps.model_inputs`` (host voxels
    or raw points), and with a camera branch the batch's ``CAMERA_KEYS`` as
    f32 tensors on ``device`` (``depth_images`` may be absent for the
    ``lss`` view transform). The GT keys (``gt_boxes``, ``gt_classes``,
    ``gt_masks_bev``) are never model inputs."""
    inputs = model_inputs(batch, device)
    if model.with_camera:
        inputs.update({k: _to_device(batch[k], device, torch.float32)
                       for k in CAMERA_KEYS if k in batch})
    return inputs


def _forward(model, inputs: Dict, stop_at: str = ""):
    if "vf" in inputs:
        rest = {k: v for k, v in inputs.items() if k not in ("vf", "vc", "vv")}
        return model(inputs["vf"].float(), inputs["vc"], inputs["vv"], stop_at, **rest)
    return model(stop_at=stop_at, **inputs)


def random_modules(model):
    """The modules that draw random masks in train mode: the decoder's
    dropout, Swin's stochastic depth, an AddFuser's modality dropout."""
    return [m for m in model.modules() if isinstance(m, (Dropout, DropPath, AddFuser))]


def dropout_generator(device, step: int) -> torch.Generator:
    """The generator of a train step's dropout masks: seeded from (key 0,
    step), as JAX's ``fold_in(PRNGKey(0), step)``, so that a resumed run
    draws the masks of the step it resumes at."""
    return torch.Generator(device=device).manual_seed(step)


def _transfusion_only(model) -> None:
    if model.head_type != "transfusion":
        raise NotImplementedError(
            f"the BEVFusion steps serve the TransFusion head; head={model.head_type!r} has "
            "no step in the JAX package either (ROADMAP C.4): use "
            "models/bevfusion/centerpoint.py's center_head_decode / center_head_loss")


def seg_loss_of(preds: Dict, batch: Dict, device) -> torch.Tensor:
    """The map-segmentation loss of a train step (JAX's branch): the logits
    resized to the targets' grid when the two differ (``resize_bilinear``,
    JAX's antialiased bilinear), then ``bev_segmentation_loss``."""
    logits = preds["seg_logits"]
    tgt = _to_device(batch["gt_masks_bev"], device, torch.float32)
    if logits.shape[1:3] != tgt.shape[1:3]:
        logits = resize_bilinear(logits, tgt.shape[1:3])
    return bev_segmentation_loss(logits, tgt)["loss"]


def make_bevfusion_train_step(bundle, optimizer, seg_loss_weight: float = 1.0
                              ) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """Train step of a ``models.builder.BEVFusionBundle`` and a
    ``solver.optim.OneCycleAdamW`` bound to its model's parameters (JAX's
    ``make_bevfusion_train_step``): the model in train mode (batch
    statistics in every batch norm; the decoder's dropout and Swin's
    stochastic depth drawn from ``dropout_generator(device,
    optimizer.count)``), the Hungarian-matched
    ``transfusion_loss``, plus ``seg_loss_weight`` x the map-segmentation
    loss (``seg_loss_of``) when the model has the seg head and the batch
    ``gt_masks_bev``, the backward and the clipped AdamW update. Returns
    0-d tensors ``loss``, ``cls_loss``, ``reg_loss``, ``heatmap_loss``,
    ``seg_loss`` (0 without map targets), ``num_matched`` and ``grad_norm``
    (before the clip).

    f32 throughout (TF32 off for cuDNN and matmuls), with cuDNN's autotuner
    on for the forward and the backward (``autotuned_convs``)."""
    _transfusion_only(bundle.model)
    _full_f32()
    model, dev = bundle.model, bundle.device
    drops = random_modules(model)

    def train_step(batch: Dict) -> Dict[str, torch.Tensor]:
        if not model.training:
            model.train()
        inputs = bevfusion_inputs(model, batch, dev)
        gt_boxes = _to_device(batch["gt_boxes"], dev, torch.float32)
        gt_classes = _to_device(batch["gt_classes"], dev, torch.int32)
        gen = dropout_generator(dev, optimizer.count)
        for d in drops:
            d.generator = gen
        optimizer.zero_grad()
        with autotuned_convs():
            preds = _forward(model, inputs)
            logs = transfusion_loss(preds, gt_boxes, gt_classes, bundle.test_cfg)
            seg = torch.zeros((), device=dev)
            if "gt_masks_bev" in batch and "seg_logits" in preds:
                seg = seg_loss_of(preds, batch, dev)
                logs["loss"] = logs["loss"] + seg_loss_weight * seg
            logs["loss"].backward()
        grad_norm = optimizer.step()
        out = {k: logs[k].detach() for k in ("loss", "cls_loss", "reg_loss", "heatmap_loss",
                                              "num_matched")}
        out.update(seg_loss=seg.detach(), grad_norm=grad_norm)
        return out

    return train_step


def make_bevfusion_predict_step(bundle) -> Callable[[Dict], Dict[str, torch.Tensor]]:
    """Detection forward of a ``models.builder.BEVFusionBundle``: the batch
    dict above in; ``transfusion_decode``'s dict out (box3d_lidar [B, P, 9],
    scores [B, P], label_preds [B, P], det_valid [B, P]) with ``bev_feat``,
    the neck's BEV map [B, H, W, 512], beside it.

    f32 throughout: making a step turns TF32 off for cuDNN convolutions and
    matmuls (the JAX reference has none). The step puts the model in eval
    mode and runs under ``torch.inference_mode``, with cuDNN's autotuner on
    for its forward: without TF32, cuDNN's default choice for SECOND's f32
    3x3 convs at 180 x 180 is an FFT algorithm that took 325 ms of a 403 ms
    predict on an H100 (``chip_smoke.py`` phase 14); the autotuner times the
    candidates on the first call of each shape and keeps the fastest. A map
    segmentation model's ``seg_logits`` come out beside ``bev_feat``."""
    _transfusion_only(bundle.model)
    _full_f32()
    model, dev = bundle.model, bundle.device

    @torch.inference_mode()
    def predict_step(batch: Dict) -> Dict[str, torch.Tensor]:
        if model.training:
            model.eval()
        with autotuned_convs():
            preds = _forward(model, bevfusion_inputs(model, batch, dev))
        out = transfusion_decode(preds, bundle.test_cfg)
        out["bev_feat"] = preds["bev_feat"]
        if "seg_logits" in preds:
            out["seg_logits"] = preds["seg_logits"]
        return out

    return predict_step
