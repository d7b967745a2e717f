"""The port against the frozen torch reference (tests/fixtures/golden_second.npz).

The fixture holds the det3d torch replica's neck / head activations and
post-NMS detections for a fully dense scene, made with the seeded det3d-named
weights of tests/oracle_utils.py. Those weights reach the port through both
bridges (det3d -> flax: dal3d_tpu/models/convert_second.py; flax -> port:
dal3d_tpu_torch/models/convert_flax.py), and again through the port's own
det3d loader (dal3d_tpu_torch/models/convert_second.py), and the port's
banded engine runs the scene at the oracle scale. Same tolerances as tests/test_golden_fixture.py.

Part 2: the port's detections of the scene through the port's nuScenes
conversion (``data/datasets/nusc_eval.py``) reproduce the frozen submission
dicts (tests/fixtures/golden_submission.json)."""
import json
import os

import numpy as np
import pytest
import torch

from dal3d_tpu.models.convert_second import convert_second_state_dict
from dal3d_tpu_torch.core.anchors import generate_task_anchors
from dal3d_tpu_torch.core.box_coders import GroundBox3dCoder
from dal3d_tpu_torch.data.datasets.nusc_eval import detections_to_nusc_boxes
from dal3d_tpu_torch.models.convert_flax import load_flax_variables
from dal3d_tpu_torch.models.convert_second import convert_second_state_dict as port_convert_second
from dal3d_tpu_torch.models.detectors.voxelnet import FPNVoxelNet
from dal3d_tpu_torch.models.heads.mg_head import TestConfig, multi_group_predict
from oracle_utils import (DS_FILTERS, DS_STRIDES, GOLDEN_CLASS_NAMES, LAYER_NUMS, NUM_CLASSES,
                          US_FILTERS, US_STRIDES, VCFG, dense_voxels, rnd_state_dict)
from torch_port_utils import t

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture(scope="module", params=["two_bridges", "port_loader"])
def port_out(request):
    """The port's outputs on the fixture's scene, its det3d weights loaded
    through both bridges (det3d -> flax -> port) or through the port's own
    det3d loader (models/convert_second.py)."""
    rng = np.random.RandomState(0)
    sd = rnd_state_dict(rng, normalized=True)
    vf, vc, vv, _ = dense_voxels(rng)
    model = FPNVoxelNet(
        VCFG.sparse_shape, num_classes=NUM_CLASSES, rpn_layer_nums=LAYER_NUMS,
        rpn_ds_strides=DS_STRIDES, rpn_ds_filters=DS_FILTERS, rpn_us_strides=US_STRIDES,
        rpn_us_filters=US_FILTERS, brick_widths=(16, 8, 4, 2, 2),
        banded_caps=(12032, 2048, 512, 256, 256)).eval()
    if request.param == "two_bridges":
        params, stats = convert_second_state_dict(sd, nested_l0=True)
        load_flax_variables(model, {"params": params, "batch_stats": stats})
    else:
        model.load_state_dict(port_convert_second(sd), strict=True)
    # the fixture's anchors / coder / test config (oracle_utils.golden_predict_setup)
    a = dict(type="anchor_generator_range", rotations=[0, 1.57], velocities=[0, 0])
    gens = [dict(**a, sizes=[1.97, 4.63, 1.74], anchor_ranges=[-8, -8, -0.95, 8, 8, -0.95]),
            dict(**a, sizes=[0.67, 0.73, 1.77], anchor_ranges=[-8, -8, -0.935, 8, 8, -0.935]),
            dict(**a, sizes=[0.41, 0.41, 1.07], anchor_ranges=[-8, -8, -1.285, 8, 8, -1.285])]
    tasks = [dict(num_class=1, class_names=["car"]),
             dict(num_class=2, class_names=["pedestrian", "traffic_cone"])]
    test_cfg = TestConfig(nms_pre_max_size=8, nms_post_max_size=4, nms_iou_threshold=0.2,
                          score_threshold=0.05,
                          post_center_limit_range=(-20.0, -20.0, -10.0, 20.0, 20.0, 10.0))
    with torch.inference_mode():
        out = model(t(vf), t(vc), t(vv))
        dets = multi_group_predict(out["preds"], generate_task_anchors(gens, tasks, [1, 2, 2]),
                                   GroundBox3dCoder(vec_encode=True, n_dim=9), test_cfg)
    return out, dets


def test_forward_matches_frozen_torch_reference(port_out):
    fix = np.load(os.path.join(FIXDIR, "golden_second.npz"))
    out, _ = port_out
    np.testing.assert_allclose(out["neck_feat"].numpy(), fix["neck_ref"], rtol=2e-3, atol=2e-3)
    for k in range(2):
        np.testing.assert_allclose(out["preds"][k]["box_preds"].numpy(), fix[f"box_ref_{k}"],
                                   rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(out["preds"][k]["cls_preds"].numpy(), fix[f"cls_ref_{k}"],
                                   rtol=2e-3, atol=2e-3)


def test_post_nms_detections_match_fixture(port_out):
    fix = np.load(os.path.join(FIXDIR, "golden_second.npz"))
    _, dets = port_out
    valid = fix["det_det_valid"]
    assert valid.sum() > 0
    np.testing.assert_array_equal(dets["det_valid"].numpy(), valid)
    np.testing.assert_array_equal(dets["label_preds"].numpy()[valid],
                                  fix["det_label_preds"][valid])
    np.testing.assert_allclose(dets["scores"].numpy()[valid], fix["det_scores"][valid],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dets["box3d_lidar"].numpy()[valid],
                               fix["det_box3d_lidar"][valid], rtol=1e-4, atol=1e-4)


def test_submission_formatting_matches_fixture(port_out):
    """Golden part 2, as tests/test_golden_fixture.py holds the JAX package."""
    with open(os.path.join(FIXDIR, "golden_submission.json")) as f:
        sub = json.load(f)
    _, dets = port_out
    info = {k: (np.asarray(v) if isinstance(v, list) else v) for k, v in sub["info"].items()}
    det0 = {k: dets[k][0].numpy() for k in ("box3d_lidar", "scores", "label_preds", "det_valid")}
    got = detections_to_nusc_boxes(det0, info, GOLDEN_CLASS_NAMES)
    ref = sub["results"]
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g["sample_token"] == r["sample_token"]
        assert g["detection_name"] == r["detection_name"]
        assert g["attribute_name"] == r["attribute_name"]
        for key in ("translation", "size", "rotation", "velocity"):
            np.testing.assert_allclose(g[key], r[key], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g["detection_score"], r["detection_score"], rtol=1e-4)
