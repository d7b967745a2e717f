"""JAX's kitti-style evaluation as the reference of the port's, at a cost the
fast lane can carry.

``dal3d_tpu.eval.kitti_eval`` calls its polygon-clip IoU once per (frame,
class, metric, bin), and every new shape costs JAX a compile of several
seconds. Here JAX computes the BEV and the 3D IoU of every prediction
against every gt box in one call each (a pair's value does not depend on the
other boxes of the call), and JAX's ``kitti_eval`` then runs its own
matching and AP sweep with its ``_bev_iou`` / ``_3d_iou`` reading those
matrices."""
from contextlib import contextmanager
from unittest import mock

import jax.numpy as jnp
import numpy as np

from dal3d_tpu.eval import kitti_eval as jke
from dal3d_tpu.ops.rotated_iou import boxes_iou3d, rotated_iou_matrix


def jax_ious(pred_frames, gt_frames):
    """(all pred boxes [P, 9], all gt boxes [G, 9], BEV IoU [P, G], 3D IoU
    [P, G]) by JAX, the boxes as f32."""
    p = np.concatenate([np.asarray(f["boxes"], np.float32).reshape(-1, 9) for f in pred_frames])
    g = np.concatenate([np.asarray(f["boxes"], np.float32).reshape(-1, 9) for f in gt_frames])
    bev = np.asarray(rotated_iou_matrix(jnp.asarray(p[:, [0, 1, 3, 4, 8]]),
                                        jnp.asarray(g[:, [0, 1, 3, 4, 8]])))
    iou3d = np.asarray(boxes_iou3d(jnp.asarray(p), jnp.asarray(g)))
    return p, g, bev, iou3d


def _rows(all_boxes, boxes):
    boxes = np.asarray(boxes, np.float32).reshape(-1, 9)
    eq = (all_boxes[None, :, :] == boxes[:, None, :]).all(-1)
    assert (eq.sum(1) >= 1).all(), "box not in the precomputed set"
    return eq.argmax(1)


@contextmanager
def precomputed_jax_iou(p, g, bev, iou3d):
    """Within the block, JAX's kitti_eval reads its IoUs from the matrices
    of ``jax_ious`` (every box it is called with must be among ``p`` /
    ``g``)."""

    def lookup(mat):
        def fn(pboxes, gboxes):
            if len(pboxes) == 0 or len(gboxes) == 0:
                return np.zeros((len(pboxes), len(gboxes)))
            return mat[np.ix_(_rows(p, pboxes), _rows(g, gboxes))]
        return fn

    with mock.patch.object(jke, "_bev_iou", lookup(bev)), \
            mock.patch.object(jke, "_3d_iou", lookup(iou3d)):
        yield
