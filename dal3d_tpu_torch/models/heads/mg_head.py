"""CBGS multi-group detection head and its predict path (port of
``dal3d_tpu/models/heads/mg_head.py``: ``MultiGroupHead``, ``LossConfig``,
``multi_group_loss``, ``TestConfig``, ``multi_group_predict``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...core.anchors import TaskAnchors
from ...core.box_coders import GroundBox3dCoder
from ...ops.iou_matrix import rotated_iou_matrix_batched
from ...ops.nms import greedy_nms_from_iou, top_k
from ..losses.losses import prepare_loss_weights, sigmoid_focal_loss, weighted_smooth_l1


class TaskHead(nn.Module):
    """One 1x1 (conv_box, conv_cls) pair, applied to NHWC maps as a matmul
    over the channel dim (the same arithmetic as a 1x1 conv)."""

    def __init__(self, cin: int, n_box: int, n_cls: int):
        super().__init__()
        self.conv_box = nn.Conv2d(cin, n_box, 1)
        self.conv_cls = nn.Conv2d(cin, n_cls, 1)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        def lin(conv):
            return F.linear(x, conv.weight.flatten(1), conv.bias)

        return {"box_preds": lin(self.conv_box), "cls_preds": lin(self.conv_cls)}


class MultiGroupHead(nn.Module):
    """One TaskHead per task group; NHWC in, NHWC out."""

    def __init__(self, num_classes: Sequence[int], in_channels: int = 512,
                 code_size: int = 10, num_rot: int = 2):
        super().__init__()
        self.tasks = nn.ModuleList(
            TaskHead(in_channels, nc * num_rot * code_size, nc * num_rot * nc)
            for nc in num_classes)

    def forward(self, x: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        return [t(x) for t in self.tasks]


@dataclass(frozen=True)
class LossConfig:
    pos_cls_weight: float = 1.0
    neg_cls_weight: float = 2.0
    # norm_by_num_positives | norm_by_num_examples | norm_by_num_pos_neg | dont_norm
    loss_norm_type: str = "norm_by_num_positives"
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    cls_loss_weight: float = 1.0
    loc_loss_weight: float = 0.25
    smooth_l1_sigma: float = 3.0
    code_weights: Tuple[float, ...] = (1.0,) * 10
    use_code_weights: bool = False  # reference quirk: code weights disabled
    encode_rad_error_by_sin: bool = False


def multi_group_loss(preds: List[Dict[str, torch.Tensor]], labels: List[torch.Tensor],
                     reg_targets: List[torch.Tensor], num_classes: Sequence[int],
                     cfg: LossConfig = LossConfig()) -> Dict[str, Any]:
    """Total loss + per-task diagnostics: focal cls + smooth-L1 reg, each
    summed and divided by the batch size, summed over tasks. labels per task
    [B, A], reg_targets per task [B, A, code]. Returns {"loss", "loc_loss":
    [T], "cls_loss": [T], "num_pos": [T]}."""
    total = 0.0
    logs: Dict[str, Any] = {"loc_loss": [], "cls_loss": [], "num_pos": []}
    for t, pred in enumerate(preds):
        nc = num_classes[t]
        B = pred["box_preds"].shape[0]
        code = reg_targets[t].shape[-1]
        box_preds = pred["box_preds"].reshape(B, -1, code)
        cls_preds = pred["cls_preds"].reshape(B, -1, nc)
        lab = labels[t]

        cls_weights, reg_weights, cared = prepare_loss_weights(
            lab, cfg.pos_cls_weight, cfg.neg_cls_weight, cfg.loss_norm_type)
        cls_targets = (lab * cared).long()
        one_hot = F.one_hot(cls_targets, nc + 1)[..., 1:].to(box_preds.dtype)

        loc_loss = weighted_smooth_l1(box_preds, reg_targets[t], reg_weights,
                                      cfg.smooth_l1_sigma, cfg.code_weights,
                                      cfg.use_code_weights)
        cls_loss = sigmoid_focal_loss(cls_preds, one_hot, cls_weights, cfg.focal_gamma,
                                      cfg.focal_alpha)
        loc_reduced = loc_loss.sum() / B * cfg.loc_loss_weight
        cls_reduced = cls_loss.sum() / B * cfg.cls_loss_weight
        total = total + loc_reduced + cls_reduced
        logs["loc_loss"].append(loc_reduced)
        logs["cls_loss"].append(cls_reduced)
        logs["num_pos"].append((lab > 0).sum())
    logs["loss"] = total
    return logs


@dataclass(frozen=True)
class TestConfig:
    __test__ = False  # not a pytest class
    nms_pre_max_size: int = 1000
    nms_post_max_size: int = 83
    nms_iou_threshold: float = 0.2
    score_threshold: float = 0.1
    post_center_limit_range: Tuple[float, ...] = (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0)
    # predict-time decode of an IoU branch (``iou_preds``), matching its
    # training loss: "smooth_l1" de-normalises and clamps, "sigmoid" squashes
    iou_decode: str = "smooth_l1"


def multi_group_predict(preds: List[Dict[str, torch.Tensor]],
                        task_anchors: List[TaskAnchors],
                        box_coder: GroundBox3dCoder,
                        cfg: TestConfig = TestConfig(),
                        iou_rescore_alpha: float = 0.0) -> Dict[str, torch.Tensor]:
    """Fixed-shape batched decode + NMS: per task, score threshold, exact
    top-k candidates (JAX's ``use_approx_topk=False`` branch, with
    ``lax.top_k``'s order among equal scores) and decode;
    then one batched rotated-IoU matrix and greedy NMS over all (task, batch)
    sets; merge with label offsets.

    When every task carries ``iou_preds`` (``heads/mg_loss_head.py::
    MultiGroupIoUHead``), the decoded per-anchor IoU (``cfg.iou_decode``) is
    threaded through candidate selection and returned per detection;
    ``iou_rescore_alpha`` > 0 ranks by score^(1-a) * iou^a (0 is the
    reference's effective behaviour: its rescoring line is commented out).

    Returns box3d_lidar [B, D, 9], scores [B, D], label_preds [B, D] (global
    class ids), det_valid [B, D], D = num_tasks * nms_post_max_size, and
    iou_preds [B, D] with an IoU branch."""
    cand_boxes, cand_scores, cand_labels, cand_ious = [], [], [], []
    label_offset = 0
    B = preds[0]["box_preds"].shape[0]
    pre = cfg.nms_pre_max_size
    code = box_coder.code_size
    with_iou = all("iou_preds" in p for p in preds)
    for t, pred in enumerate(preds):
        ta = task_anchors[t]
        nc = ta.num_classes
        box_preds = pred["box_preds"].reshape(B, -1, code)  # NHWC -> anchor order
        cls_preds = pred["cls_preds"].reshape(B, -1, nc)
        anchors = torch.as_tensor(ta.anchors, device=box_preds.device)

        scores = torch.sigmoid(cls_preds)
        if nc > 1:
            top_scores, top_labels = scores.max(dim=-1)
        else:
            top_scores = scores[..., 0]
            top_labels = torch.zeros_like(top_scores, dtype=torch.long)
        if with_iou:
            from .mg_loss_head import decode_iou_preds

            iou_dec = decode_iou_preds(pred["iou_preds"].reshape(B, -1), cfg.iou_decode)
            if iou_rescore_alpha > 0.0:
                top_scores = (torch.pow(top_scores, 1.0 - iou_rescore_alpha)
                              * torch.pow(iou_dec, iou_rescore_alpha))
        masked = torch.where(top_scores >= cfg.score_threshold, top_scores,
                             torch.full_like(top_scores, float("-inf")))
        csc, cidx = top_k(masked, pre)  # [B, pre], descending, ties as lax.top_k
        cand_bp = torch.gather(box_preds, 1, cidx[..., None].expand(B, pre, code))
        cand_boxes.append(box_coder.decode(cand_bp, anchors[cidx]))
        cand_scores.append(csc)
        cand_labels.append(torch.gather(top_labels, 1, cidx) + label_offset)
        if with_iou:
            cand_ious.append(torch.gather(iou_dec, 1, cidx))
        label_offset += nc

    T = len(preds)
    boxes_all = torch.stack(cand_boxes).reshape(T * B, pre, -1)
    scores_all = torch.stack(cand_scores).reshape(T * B, pre)
    labels_all = torch.stack(cand_labels).reshape(T * B, pre)
    valid_all = torch.isfinite(scores_all)

    bev_all = boxes_all[:, :, [0, 1, 3, 4, 8]].contiguous()
    iou_all = rotated_iou_matrix_batched(bev_all, bev_all)
    keep = greedy_nms_from_iou(iou_all, valid_all, cfg.nms_iou_threshold)
    post = cfg.nms_post_max_size
    ks, sel = top_k(torch.where(keep, scores_all, torch.full_like(scores_all, float("-inf"))),
                    post)
    kv = torch.isfinite(ks)
    sel_boxes = torch.gather(boxes_all, 1, sel[..., None].expand(T * B, post, boxes_all.shape[-1]))
    sel_scores = torch.gather(scores_all, 1, sel)
    sel_labels = torch.gather(labels_all, 1, sel)

    pcr = torch.as_tensor(cfg.post_center_limit_range, dtype=sel_boxes.dtype,
                          device=sel_boxes.device)
    in_range = (sel_boxes[..., :3] >= pcr[:3]).all(-1) & (sel_boxes[..., :3] <= pcr[3:]).all(-1)
    kv = kv & in_range

    def unfold(x):  # [T*B, post] -> [B, T*post], task-major within a sample
        return x.reshape(T, B, post, *x.shape[2:]).transpose(0, 1).reshape(B, T * post, *x.shape[2:])

    out = {
        "box3d_lidar": unfold(sel_boxes),
        "scores": unfold(torch.where(kv, sel_scores, torch.zeros_like(sel_scores))),
        "label_preds": unfold(sel_labels).to(torch.int32),
        "det_valid": unfold(kv),
    }
    if with_iou:
        sel_ious = torch.gather(torch.stack(cand_ious).reshape(T * B, pre), 1, sel)
        out["iou_preds"] = unfold(torch.where(kv, sel_ious, torch.zeros_like(sel_ious)))
    return out
