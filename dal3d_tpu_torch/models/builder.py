"""Config-driven model construction (port of
``dal3d_tpu/models/builder.py::build_detector``): config dict -> model on a
device, task anchors, box coder, target assigner, loss and test config; and
``build_bevfusion``, the construction that the JAX package writes inline in
``tools/train_bevfusion.py`` and ``tools/profile_bevfusion.py``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List

import numpy as np
import torch
from torch import nn

from ..core.anchors import TaskAnchors, generate_task_anchors
from ..core.box_coders import GroundBox3dCoder, build_box_coder
from ..core.target_assigner import DeviceTargetAssigner
from ..device import resolve_device
from ..ops.voxelize import VoxelConfig
from .backbones.scn import (BANDED_CAPS_DEFAULT, BRICK_CAPS_DEFAULT, BRICK_WIDTHS_DEFAULT,
                             VOXEL_CAPS_DEFAULT)
from .bevfusion import BEVFusion, TransFusionTestCfg
from .bevfusion.centerpoint import CenterTestCfg
from .bevfusion.segm import SEG_CLASSES
from .bevfusion.sparse_encoder import ENCODER_CHANNELS, VOXEL_CAPS
from .bevfusion.swin import WindowAttention
from .detectors.voxelnet import FPNVoxelNet
from .heads.mg_head import LossConfig, TestConfig
from .layers import BatchNorm2d, MaskedBatchNorm, SparseConvDown, SubMConv
from .necks.rpn import ConvBN

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class DetectorBundle:
    """Everything the train and predict steps need, built once from a
    config."""

    model: Any  # FPNVoxelNet on ``device``
    voxel_cfg: VoxelConfig  # the device voxelizer's grid (raw-point batches)
    task_anchors: List[TaskAnchors]
    box_coder: GroundBox3dCoder
    assigner: DeviceTargetAssigner
    loss_cfg: LossConfig
    test_cfg: TestConfig
    num_classes: tuple
    device: torch.device


def grid_size(voxel_generator) -> tuple:
    """(Nx, Ny, Nz) = round((range_max - range_min) / voxel_size)."""
    r = np.asarray(voxel_generator["range"], np.float64)
    vs = np.asarray(voxel_generator["voxel_size"], np.float64)
    g = np.round((r[3:] - r[:3]) / vs).astype(np.int64)
    return int(g[0]), int(g[1]), int(g[2])


def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights that keep activations O(1) through the stack:
    convs ~ N(0, 2/fan_in) (a ReLU follows), linear layers ~ N(0, 1/fan_in)
    (attention logits and the prediction FFNs' outputs stay O(1), so box
    sizes exp(dim) stay finite), biases ~ 0.05 N(0, 1), BN and LayerNorm
    affine and BN running statistics near the identity with 10-20 % spread,
    Swin's relative position bias tables ~ 0.02 N(0, 1).
    Draws on the CPU from ``generator``, so one seed gives the same weights
    on every device."""
    with torch.no_grad():
        for m in model.modules():
            gain = 2.0
            if isinstance(m, (SubMConv, SparseConvDown)):  # [K, Cin, Cout]
                fan_in = m.weight.shape[0] * m.weight.shape[1]
            elif isinstance(m, ConvBN):  # [Cin, Cout, k, k] if transpose
                fan_in = (m.weight.shape[0] if m.transpose
                          else int(np.prod(m.weight.shape[1:])))
            elif isinstance(m, nn.Conv2d):
                fan_in = int(np.prod(m.weight.shape[1:]))
            elif isinstance(m, nn.Linear):
                fan_in, gain = m.weight.shape[1], 1.0
            else:
                fan_in = 0
            if fan_in:
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * float(np.sqrt(gain / fan_in)))
            if isinstance(m, (MaskedBatchNorm, BatchNorm2d)):
                C = m.weight.shape[0]
                m.weight.copy_(1 + 0.2 * torch.randn(C, generator=generator))
                m.bias.copy_(0.1 * torch.randn(C, generator=generator))
                m.running_mean.copy_(0.1 * torch.randn(C, generator=generator))
                m.running_var.copy_(1 + 0.1 * torch.rand(C, generator=generator))
            elif isinstance(m, nn.LayerNorm):
                C = m.weight.shape[0]
                m.weight.copy_(1 + 0.1 * torch.randn(C, generator=generator))
                m.bias.copy_(0.05 * torch.randn(C, generator=generator))
            elif isinstance(m, (nn.Conv2d, nn.Linear)) and m.bias is not None:
                m.bias.copy_(0.05 * torch.randn(m.bias.shape, generator=generator))
            elif isinstance(m, WindowAttention):
                t = m.relative_position_bias_table
                t.copy_(0.02 * torch.randn(t.shape, generator=generator))
    return model


def build_detector(cfg, device=None, seed: int = 0) -> DetectorBundle:
    """cfg: experiment Config (model / tasks / voxel_generator / box_coder /
    target_assigner / test_cfg). The backbone's ``impl`` is every engine of
    JAX's: "gather" when the config names none, as in JAX (``voxel_caps``),
    "banded" (``brick_widths``, ``banded_caps``), "brick" (``brick_widths``,
    ``brick_caps``), "hybrid" (``voxel_caps``; its L0 is the gather engine)
    and "dense". Every engine runs in the config's ``dtype``, float32 or
    bfloat16, as JAX's (the gather kernels K4 and K4-dW have a build for
    each). The model gets seeded random weights (``init_random_``); load
    trained ones with ``model.load_state_dict``. ``device=None`` means the
    CUDA card and raises when there is none."""
    dev = resolve_device(device)
    model_cfg = dict(cfg["model"])
    if model_cfg.get("type") not in ("FPNVoxelNet", "VoxelNet"):
        raise KeyError(f"unknown detector: {model_cfg.get('type')}")
    backbone_cfg = dict(model_cfg.get("backbone", {}))
    impl = str(backbone_cfg.get("impl", "gather"))
    dtype = str(backbone_cfg.get("dtype", "float32"))
    vg = cfg["voxel_generator"]
    voxel_cfg = VoxelConfig(tuple(vg["range"]), tuple(vg["voxel_size"]),
                            int(vg["max_points_in_voxel"]), int(vg["max_voxel_num"]))
    nx, ny, _ = voxel_cfg.grid_size
    sparse_shape = voxel_cfg.sparse_shape

    tasks = [dict(t) for t in cfg["tasks"]]
    num_classes = tuple(int(t["num_class"]) for t in tasks)
    box_coder = build_box_coder(dict(cfg["box_coder"]))
    ds_factor = int(backbone_cfg.get("ds_factor", 8))
    task_anchors = generate_task_anchors(
        [dict(g) for g in cfg["target_assigner"]["anchor_generators"]], tasks,
        [1, ny // ds_factor, nx // ds_factor])

    assigner = DeviceTargetAssigner(task_anchors, box_coder)

    head_cfg = model_cfg.get("bbox_head", {}) or {}
    loss_cls = head_cfg.get("loss_cls", {}) or {}
    loss_bbox = head_cfg.get("loss_bbox", {}) or {}
    loss_norm = head_cfg.get("loss_norm", {}) or {}
    # reference LossNormType names -> models/losses/losses.py ids
    norm_map = {
        "NormByNumPositives": "norm_by_num_positives",
        "NormByNumExamples": "norm_by_num_examples",
        "NormByNumPosNeg": "norm_by_num_pos_neg",
        "DontNorm": "dont_norm",
    }
    loss_cfg = LossConfig(
        pos_cls_weight=float(loss_norm.get("pos_cls_weight", 1.0)),
        neg_cls_weight=float(loss_norm.get("neg_cls_weight", 1.0)),
        loss_norm_type=norm_map[loss_norm.get("type", "NormByNumPositives")],
        focal_gamma=float(loss_cls.get("gamma", 2.0)),
        focal_alpha=float(loss_cls.get("alpha", 0.25)),
        cls_loss_weight=float(loss_cls.get("loss_weight", 1.0)),
        loc_loss_weight=float(loss_bbox.get("loss_weight", 1.0)),
        smooth_l1_sigma=float(loss_bbox.get("sigma", 3.0)),
        code_weights=tuple(loss_bbox.get("code_weights", (1.0,) * box_coder.code_size)),
        encode_rad_error_by_sin=bool(head_cfg.get("encode_rad_error_by_sin", False)),
    )

    tcfg = dict(cfg.get("test_cfg", {}) or {})
    nms = dict(tcfg.get("nms", {}))
    test_cfg = TestConfig(
        nms_pre_max_size=int(nms.get("nms_pre_max_size", 1000)),
        nms_post_max_size=int(nms.get("nms_post_max_size", 83)),
        nms_iou_threshold=float(nms.get("nms_iou_threshold", 0.2)),
        score_threshold=float(tcfg.get("score_threshold", 0.1)),
        post_center_limit_range=tuple(
            tcfg.get("post_center_limit_range", (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0))),
    )

    neck_cfg = dict(model_cfg.get("neck", {}) or {})
    reader_cfg = dict(model_cfg.get("reader", {}) or {})
    model = FPNVoxelNet(
        sparse_shape, num_classes=num_classes, code_size=box_coder.code_size,
        num_input_features=int(reader_cfg.get("num_input_features", 5)),
        rpn_layer_nums=tuple(neck_cfg.get("layer_nums", (5, 5))),
        rpn_ds_strides=tuple(neck_cfg.get("ds_layer_strides", (1, 2))),
        rpn_ds_filters=tuple(neck_cfg.get("ds_num_filters", (128, 256))),
        rpn_us_strides=tuple(neck_cfg.get("us_layer_strides", (1, 2))),
        rpn_us_filters=tuple(neck_cfg.get("us_num_filters", (256, 256))),
        backbone_dtype=_DTYPES[dtype],
        brick_widths=tuple(backbone_cfg.get("brick_widths", BRICK_WIDTHS_DEFAULT)),
        banded_caps=tuple(backbone_cfg.get("banded_caps", BANDED_CAPS_DEFAULT)),
        voxel_cfg=voxel_cfg, backbone_impl=impl,
        voxel_caps=tuple(backbone_cfg.get("voxel_caps", VOXEL_CAPS_DEFAULT)),
        brick_caps=tuple(backbone_cfg.get("brick_caps", BRICK_CAPS_DEFAULT)),
    )
    init_random_(model, torch.Generator().manual_seed(seed))
    return DetectorBundle(
        model=model.to(dev).eval(), voxel_cfg=voxel_cfg, task_anchors=task_anchors,
        box_coder=box_coder, assigner=assigner, loss_cfg=loss_cfg, test_cfg=test_cfg,
        num_classes=num_classes, device=dev)


def host_voxelize_cfg(cfg):
    """``voxelize_host`` dict for the data pipeline (the voxel_generator
    knobs: range, voxel_size, max_points_in_voxel, max_voxel_num, bf16), or
    None when the config sets ``voxelize_host = False``: the loaders then ship
    the padded raw points alone, and the steps voxelize them on the device
    (``ops/voxelize.py``). No brick-plan sub-dict: the backbone builds its
    plans on the GPU."""
    if not cfg.get("voxelize_host", True):
        return None
    return dict(cfg["voxel_generator"])


def loader_voxelize_cfg(cfg):
    """``voxelize_host`` for loader-fed passes (pool scoring, eval). With no
    host plans to decide on, this is ``host_voxelize_cfg``."""
    return host_voxelize_cfg(cfg)


@dataclass
class BEVFusionBundle:
    """What the BEVFusion steps need, built once from a config."""

    model: Any  # BEVFusion on ``device``
    test_cfg: Any  # TransFusionTestCfg, or CenterTestCfg for head="centerpoint"
    voxel_cfg: VoxelConfig
    device: torch.device


def build_bevfusion(cfg, device=None, seed: int = 0) -> BEVFusionBundle:
    """cfg: a BEVFusion experiment Config (model / voxel_generator /
    test_cfg, as ``configs/bevfusion_lidar.py`` or the camera + lidar
    ``configs/bevfusion_cl.py``: ``with_camera``, ``with_lidar``,
    ``vtransform`` ("depth_lss" | "lss"), ``image_size``,
    ``camera_out_channels`` and ``with_map_seg`` are read as JAX's
    ``tools/train_bevfusion.py`` reads them; ``head`` ("transfusion" |
    "centerpoint"), ``center_task_classes`` and ``seg_classes`` as JAX's
    ``BEVFusion`` takes them). The bundle's ``test_cfg`` is a
    ``TransFusionTestCfg``, or for the CenterPoint head a ``CenterTestCfg``
    (``max_per_task`` 83 unless the config's test_cfg says otherwise). The
    model gets seeded random weights (``init_random_``); load trained ones
    with ``models/convert_flax.py::load_flax_bevfusion`` or
    ``load_state_dict``. ``device=None`` means the CUDA card and raises when
    there is none. ``bevfusion_optimizer`` builds the training optimizer of
    the same config."""
    mc = dict(cfg["model"])
    if mc.get("type") != "BEVFusion":
        raise KeyError(f"build_bevfusion: model type {mc.get('type')!r} is not BEVFusion")
    dev = resolve_device(device)
    vg = cfg["voxel_generator"]
    voxel_cfg = VoxelConfig(tuple(vg["range"]), tuple(vg["voxel_size"]),
                            int(vg["max_points_in_voxel"]), int(vg["max_voxel_num"]))
    model = BEVFusion(
        voxel_cfg, with_camera=bool(mc.get("with_camera", False)),
        num_classes=int(mc.get("num_classes", 10)),
        num_proposals=int(mc.get("num_proposals", 200)),
        decoder_channels=tuple(mc.get("decoder_channels", (128, 256))),
        decoder_layer_nums=tuple(mc.get("decoder_layer_nums", (5, 5))),
        neck_out_channels=tuple(mc.get("neck_out_channels", (256, 256))),
        voxel_caps=tuple(mc.get("voxel_caps", VOXEL_CAPS)),
        encoder_channels=tuple(tuple(c) for c in mc.get("encoder_channels", ENCODER_CHANNELS)),
        hidden_channel=int(mc.get("hidden_channel", 128)),
        num_heads=int(mc.get("num_heads", 8)),
        ffn_channel=int(mc.get("ffn_channel", 256)),
        with_lidar=bool(mc.get("with_lidar", True)),
        vtransform=str(mc.get("vtransform", "depth_lss")),
        image_size=tuple(mc.get("image_size", (256, 704))),
        camera_out_channels=int(mc.get("camera_out_channels", 80)),
        head=str(mc.get("head", "transfusion")),
        center_task_classes=tuple(mc.get("center_task_classes", (1, 2, 2, 1, 2, 2))),
        with_map_seg=bool(mc.get("with_map_seg", False)),
        seg_classes=tuple(mc.get("seg_classes", SEG_CLASSES)),
    )
    init_random_(model, torch.Generator().manual_seed(seed))
    tc = dict(cfg.get("test_cfg", {}) or {})
    if model.head_type == "centerpoint":
        test_cfg = CenterTestCfg(
            out_size_factor=int(tc.get("out_size_factor", 8)),
            voxel_size=tuple(tc.get("voxel_size", (0.1, 0.1))),
            pc_range=tuple(tc.get("pc_range", (-51.2, -51.2))),
            max_per_task=int(tc.get("max_per_task", 83)),
            score_threshold=float(tc.get("score_threshold", 0.1)))
    else:
        test_cfg = TransFusionTestCfg(
            out_size_factor=int(tc.get("out_size_factor", 8)),
            voxel_size=tuple(tc.get("voxel_size", (0.075, 0.075))),
            pc_range=tuple(tc.get("pc_range", (-54.0, -54.0))),
            score_threshold=float(tc.get("score_threshold", 0.0)),
        )
    return BEVFusionBundle(model=model.to(dev).eval(), test_cfg=test_cfg,
                           voxel_cfg=voxel_cfg, device=dev)


def bevfusion_optimizer(cfg, bundle, total_steps: int):
    """The BEVFusion CLI's optimizer (JAX's ``tools/train_bevfusion.py``):
    OneCycle AdamW with the config's ``lr_config.lr_max`` (default 1e-4)
    over ``total_steps``, weight decay ``optimizer.VALUE.wd`` (0.01), global
    norm clip 35, bound to the bundle's model."""
    from ..solver.optim import OneCycleSchedule, build_optimizer

    lr = dict(cfg.get("lr_config", {}) or {})
    wd = dict(dict(cfg.get("optimizer", {}) or {}).get("VALUE", {}) or {}).get("wd", 0.01)
    opt = build_optimizer(OneCycleSchedule(lr_max=lr.get("lr_max", 1e-4),
                                           total_steps=total_steps), weight_decay=wd)
    return opt.init(bundle.model.named_parameters())


def eval_test_cfg(cfg, logger=None) -> dict:
    """The metric evaluation's test_cfg (JAX's ``eval_test_cfg``): the exact
    top-k prefilter unless the config asks for the approximate one, so that a
    reported mAP is reproducible. The log names the flag as JAX's does; the
    port's head takes the exact stable top k under either
    (``heads/mg_head.py::multi_group_predict``), which is what XLA's
    ``approx_max_k`` computes off the TPU."""
    tcfg = dict(cfg.get("test_cfg", {}) or {})
    nms = dict(tcfg.get("nms", {}))
    nms.setdefault("use_approx_topk", False)
    tcfg["nms"] = nms
    if logger is not None:
        logger.info(f"top-k prefilter: {'approx' if nms['use_approx_topk'] else 'exact'} "
                    "(the approximate top-k is exact off the TPU, as XLA's approx_max_k)")
    return tcfg
