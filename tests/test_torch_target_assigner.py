"""Port parity: box encoding, the nearest-IoU similarity and the on-device
target assignment (dal3d_tpu_torch/core/{box_ops,anchors,target_assigner}.py)
against dal3d_tpu/core on the same numpy inputs. Labels must be equal,
targets within 1e-5."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.core import box_ops_jax
from dal3d_tpu.core.anchors import generate_task_anchors as jax_anchors
from dal3d_tpu.core.box_coders import GroundBox3dCoder as JaxCoder
from dal3d_tpu.core.target_assigner import DeviceTargetAssigner as JaxAssigner
from dal3d_tpu.core.target_assigner import assign_one_class as jax_assign_one_class
from dal3d_tpu_torch.core import box_ops
from dal3d_tpu_torch.core.anchors import generate_task_anchors
from dal3d_tpu_torch.core.box_coders import GroundBox3dCoder
from dal3d_tpu_torch.core.target_assigner import DeviceTargetAssigner, assign_one_class
from dal3d_tpu_torch.utils.config import Config
from torch_port_utils import small_cfg, small_gt, t

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def _boxes(rng, n, ndim=9):
    b = np.zeros((n, ndim), np.float32)
    b[:, :3] = rng.uniform(-10, 10, (n, 3))
    b[:, 3:6] = rng.uniform(0.4, 6.0, (n, 3))
    b[:, 6:-1] = rng.uniform(-2, 2, (n, ndim - 7))
    b[:, -1] = rng.uniform(-7, 7, n)
    return b


@pytest.mark.parametrize("vec,smooth,ndim", [(True, False, 9), (False, False, 7), (False, True, 9)])
def test_box_encode_matches_jax(vec, smooth, ndim):
    rng = np.random.RandomState(0)
    boxes, anchors = _boxes(rng, 200, ndim), _boxes(rng, 200, ndim)
    ref = box_ops_jax.second_box_encode(jnp.asarray(boxes), jnp.asarray(anchors), vec, smooth)
    got = box_ops.second_box_encode(t(boxes), t(anchors), vec, smooth)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    if vec:
        coder = GroundBox3dCoder(vec_encode=True, n_dim=ndim)
        back = coder.decode(coder.encode(t(boxes), t(anchors)), t(anchors)).numpy()
        np.testing.assert_allclose(back[:, :-1], boxes[:, :-1], rtol=1e-4, atol=1e-4)


def test_similarity_pieces_match_jax():
    rng = np.random.RandomState(1)
    a, g = _boxes(rng, 300)[:, [0, 1, 3, 4, 8]], _boxes(rng, 40)[:, [0, 1, 3, 4, 8]]
    g[:5] = a[:5]  # identical boxes: IoU 1
    np.testing.assert_allclose(box_ops.limit_period(t(a[:, 4]), 0.5, np.pi).numpy(),
                               np.asarray(box_ops_jax.limit_period(jnp.asarray(a[:, 4]), 0.5, np.pi)),
                               atol=1e-6)
    np.testing.assert_allclose(box_ops.rbbox2d_to_near_bbox(t(a)).numpy(),
                               np.asarray(box_ops_jax.rbbox2d_to_near_bbox(jnp.asarray(a))),
                               atol=1e-6)
    ref = np.asarray(box_ops_jax.nearest_iou_similarity(jnp.asarray(a), jnp.asarray(g)))
    got = box_ops.nearest_iou_similarity(t(a), t(g)).numpy()
    assert ref.max() == 1.0 and (ref > 0).sum() > 50
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    near = box_ops.rbbox2d_to_near_bbox(t(a))
    np.testing.assert_allclose(
        box_ops.pairwise_iou_aa(near, near, eps=1.0).numpy(),
        np.asarray(box_ops_jax.pairwise_iou_aa(jnp.asarray(near.numpy()), jnp.asarray(near.numpy()),
                                               eps=1.0)), rtol=1e-6, atol=1e-7)


def test_task_anchor_bundles_match_jax():
    cfg = Config.fromfile(os.path.join(CONFIGS, "cbgs_spatial_temporal.py"))
    gens = [dict(g) for g in cfg["target_assigner"]["anchor_generators"]]
    tasks = [dict(x) for x in cfg["tasks"]]
    for r, g in zip(jax_anchors(gens, tasks, [1, 16, 16]), generate_task_anchors(gens, tasks, [1, 16, 16])):
        np.testing.assert_array_equal(g.anchors_by_class, r.anchors_by_class)
        np.testing.assert_array_equal(g.matched_thresholds, r.matched_thresholds)
        np.testing.assert_array_equal(g.unmatched_thresholds, r.unmatched_thresholds)
        assert g.feature_map_size == r.feature_map_size and g.num_rot == r.num_rot
        assert g.num_classes == r.num_classes


def test_assign_one_class_matches_jax():
    """One class: ties, a GT with no overlap, an invalid GT, thresholds that
    leave an ignore band."""
    rng = np.random.RandomState(2)
    xs, ys = np.meshgrid(np.arange(-8, 8, 1.0), np.arange(-8, 8, 1.0))
    anchors = np.zeros((512, 9), np.float32)
    anchors[:, 0], anchors[:, 1] = np.tile(xs.ravel(), 2), np.tile(ys.ravel(), 2)
    anchors[:, 2], anchors[:, 3:6] = -1.0, [1.9, 4.6, 1.7]
    anchors[256:, 8] = 1.57
    gt = _boxes(rng, 6)
    gt[:, :2] = rng.uniform(-7, 7, (6, 2))
    gt[:, 3:6] = [2.0, 4.5, 1.6]
    gt[0, :2] = [0.5, 0.5]  # equidistant from four anchors: ties
    gt[0, 8] = 0.0
    gt[4, :2] = [40.0, 40.0]  # overlaps nothing
    valid = np.array([1, 1, 1, 1, 1, 0], bool)
    ref = jax_assign_one_class(jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(valid),
                               jnp.asarray(2), jnp.asarray(0.6), jnp.asarray(0.45), True)
    got = assign_one_class(t(anchors), t(gt), t(valid), torch.tensor(2), torch.tensor(0.6),
                           torch.tensor(0.45), True)
    labels = np.asarray(ref[0])
    assert set(np.unique(labels)) == {-1, 0, 2}
    np.testing.assert_array_equal(got[0].numpy(), labels)
    assert got[0].dtype == torch.int32
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    # no valid GT at all: every label 0
    none = assign_one_class(t(anchors), t(gt), t(np.zeros(6, bool)), torch.tensor(2),
                            torch.tensor(0.6), torch.tensor(0.45), True)
    assert int(none[0].abs().sum()) == 0 and float(none[1].abs().sum()) == 0.0


@pytest.mark.parametrize("per_task", [1, 5])
def test_assign_all_matches_jax(per_task):
    """The batched assignment over six task groups, on the small config's
    8 x 8 anchor map."""
    cfg = small_cfg()
    gens = [dict(g) for g in cfg["target_assigner"]["anchor_generators"]]
    tasks = [dict(x) for x in cfg["tasks"]]
    gt_boxes, gt_classes = small_gt(cfg, 4, per_task=per_task)
    gt_classes[1][0, per_task - 1] = 0  # a padded slot in the middle of the valid ones
    ref = JaxAssigner(jax_anchors(gens, tasks, [1, 8, 8]),
                      JaxCoder(vec_encode=True, n_dim=9)).assign_all(
        [jnp.asarray(b) for b in gt_boxes], [jnp.asarray(c) for c in gt_classes])
    got = DeviceTargetAssigner(generate_task_anchors(gens, tasks, [1, 8, 8]),
                               GroundBox3dCoder(vec_encode=True, n_dim=9)).assign_all(
        [t(b) for b in gt_boxes], [t(c) for c in gt_classes])
    n_pos = 0
    for k in range(len(tasks)):
        lab = np.asarray(ref[0][k])
        np.testing.assert_array_equal(got[0][k].numpy(), lab, err_msg=f"task {k}")
        np.testing.assert_allclose(got[1][k].numpy(), np.asarray(ref[1][k]), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got[2][k].numpy(), np.asarray(ref[2][k]))
        assert got[1][k].shape == (2, lab.shape[1], 10)
        n_pos += int((lab > 0).sum())
    assert n_pos >= 2 * len(tasks) * per_task - 2
