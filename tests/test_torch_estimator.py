"""Port parity for the partial-label estimator path on the CPU: the box
pool, the ``Estimator`` / ``PPEstimator`` forward, one estimator step of
``runtime/active_trainer.py`` against JAX's ``make_estimator_step``, the
estimator's weights through ``estimator.npz`` both ways, and the trainer's
capacity report.

The estimator step: the production CBGS config cut to a 12.8 m grid and
two task groups (tests/torch_port_utils.py::small_cfg), f32, score
threshold 0 (with random weights no detection clears 0.1, ``det_valid``
would be empty and every gradient zero). The detector is replaced on both
sides by the same seeded head maps (its forward from raw points is held
against JAX's in tests/test_torch_raw_points.py; here a JAX compile of it
would cost more than the rest of the file); the estimator's flax
initialisation is carried by models/convert_flax.py; raw points from
tests/test_torch_raw_points.py::small_points, GT boxes on some of JAX's
detections so that targets are not all zero. Held: ``det_valid`` equal and
non-empty, targets within 1e-5, loss within 1e-5 relative, the gradient
within 1e-4 of its norm, and the Adam update within 1e-6 where |g| > 1e-6.
The real (small) detector runs in the ActiveTrainer test, where its
predict must leave the batch-norm statistics and the train mode alone."""
import dataclasses
import logging
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dal3d_tpu.models.builder import build_detector as jax_build
from dal3d_tpu.models.detectors import estimator as je
from dal3d_tpu.models.heads.mg_head import multi_group_predict as jax_predict
from dal3d_tpu.ops.rotated_iou_fast import boxes_iou3d_fast as jax_iou3d
from dal3d_tpu.runtime.active_trainer import EstimatorState
from dal3d_tpu.runtime.active_trainer import make_estimator_step as jax_make_estimator_step
from dal3d_tpu.runtime.steps import TrainState
from dal3d_tpu.utils.config import Config as JaxConfig
from dal3d_tpu_torch.models.builder import build_detector
from dal3d_tpu_torch.models.convert_flax import estimator_flax_to_state_dict, estimator_to_flat
from dal3d_tpu_torch.models.detectors import estimator as te
from dal3d_tpu_torch.runtime import active_trainer as ta
from dal3d_tpu_torch.solver.optim import Adam
from test_torch_raw_points import raw_cfg, small_points
from torch_port_utils import small_cfg, small_voxels, t

MAX_PTS, HIDDEN, LR, NUM_BOXES = 128, (64, 128), 1e-3, 64


def _cfg():
    cfg = raw_cfg()
    cfg["test_cfg"]["score_threshold"] = 0.0
    return cfg


def _pool_cloud(seed=0, P=3000):
    """A cloud [P, 5] (intensity = the point's index) and boxes [K, 9]: a
    box holding more than MAX_PTS points, an empty box, random ones."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((P, 5), np.float32)
    pts[:, :3] = rng.uniform([-6, -6, -2], [6, 6, 1], (P, 3))
    pts[:400, :3] = rng.uniform([0.5, 0.5, -1.5], [2.5, 2.5, 0.5], (400, 3))  # dense box
    rng.shuffle(pts)
    pts[:, 3] = np.arange(P)
    valid = rng.rand(P) > 0.05
    boxes = np.zeros((8, 9), np.float32)
    boxes[0] = [1.5, 1.5, -1.5, 2.0, 2.0, 2.0, 0, 0, 0]
    boxes[1] = [30.0, 30.0, 0.0, 1.0, 1.0, 1.0, 0, 0, 0.3]  # empty
    boxes[2:, :3] = rng.uniform([-5, -5, -2], [5, 5, -1], (6, 3))
    boxes[2:, 3:6] = rng.uniform(0.5, 4.0, (6, 3))
    boxes[2:, 8] = rng.uniform(-np.pi, np.pi, 6)
    return pts, valid, boxes


def test_pool_selects_jax_points():
    """Mask and selected indices bit-equal to JAX's top_k over ``inside -
    index * 1e-9`` (estimator.py:40-41), on a box with more interior points
    than MAX_PTS and an empty box; features within 1e-6."""
    pts, valid, boxes = _pool_cloud()
    jf, jm = jax.jit(je.points_in_box_pool, static_argnums=3)(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(boxes), MAX_PTS)
    tf, tm = te.points_in_box_pool(t(pts), t(valid), t(boxes), MAX_PTS)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-6)
    assert tm[0].all() and not tm[1].any() and 0 < tm[2:].sum() < tm[2:].numel()

    # the indices themselves: JAX's ranking against pool_order
    def jax_idx(inside):
        score = jnp.where(inside, 1.0, 0.0) - jnp.arange(inside.shape[1])[None, :] * 1e-9
        return jax.lax.top_k(score, MAX_PTS)[1]

    rng = np.random.RandomState(1)
    for P in (3000, 300000):
        inside = rng.rand(6, P) < np.array([[0.9], [0.0], [1e-4], [0.02], [1.0], [0.5]])
        np.testing.assert_array_equal(te.pool_order(t(inside), MAX_PTS).numpy(),
                                      np.asarray(jax.jit(jax_idx)(jnp.asarray(inside))))


@pytest.mark.parametrize("kind", ["Estimator", "PPEstimator"])
def test_estimator_forward_matches_jax(kind):
    """Forward with carried weights within 1e-5, the empty box included
    (its -1e9 max-pool goes on into the dense layer, as in JAX)."""
    pts, valid, boxes = _pool_cloud(2)
    P = np.stack([pts, pts[::-1].copy()])
    V = np.stack([valid, valid])
    Bx = np.stack([boxes, boxes[::-1].copy()])
    jm = getattr(je, kind)()
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(P), jnp.asarray(V),
                     jnp.asarray(Bx))["params"]
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(P), jnp.asarray(V),
                                       jnp.asarray(Bx)))
    tm = getattr(te, kind)()
    tm.load_state_dict(estimator_flax_to_state_dict(params, tm), strict=True)
    got = tm(t(P), t(V), t(Bx)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_estimator_weights_round_trip_through_npz(tmp_path):
    """Port -> estimator.npz (JAX's flat names and [in, out] kernels, as
    JAX's tools/train.py writes it) -> a flax tree JAX's Estimator applies
    -> back into a port Estimator: every value equal."""
    from dal3d_tpu.models.convert_second import flatten_tree, unflatten_tree

    tm = te.init_estimator_(te.Estimator(MAX_PTS, HIDDEN), torch.Generator().manual_seed(1))
    path = str(tmp_path / "estimator.npz")
    np.savez(path, **estimator_to_flat(tm))
    flat = dict(np.load(path))
    jm = je.Estimator(MAX_PTS, HIDDEN)
    pts, valid, boxes = _pool_cloud(4)
    args = (jnp.asarray(pts[None]), jnp.asarray(valid[None]), jnp.asarray(boxes[None]))
    jparams = jm.init(jax.random.PRNGKey(0), *args)["params"]
    want = flatten_tree(jax.device_get(jparams))
    assert sorted(flat) == sorted(want)
    assert all(flat[k].shape == want[k].shape and flat[k].dtype == np.float32 for k in want)
    ref = np.asarray(jm.apply({"params": unflatten_tree(flat)}, *args))
    np.testing.assert_allclose(tm(*[t(np.asarray(a)) for a in args]).detach().numpy(), ref,
                               rtol=1e-5, atol=1e-6)
    back = te.Estimator(MAX_PTS, HIDDEN)
    back.load_state_dict(estimator_flax_to_state_dict(unflatten_tree(flat), back), strict=True)
    for k, v in tm.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    # the port's draw follows flax's default Dense initialisation
    for i in range(len(HIDDEN) + 2):
        k = flat[f"Dense_{i}/kernel"]
        assert np.all(flat[f"Dense_{i}/bias"] == 0)
        assert np.abs(k).max() <= 2 / 0.8796 * np.sqrt(1 / k.shape[0]) + 1e-6
        assert 0.5 < k.std() * np.sqrt(k.shape[0]) < 1.5 or k.size < 16


@pytest.mark.parametrize("where", ["without_detection", "with_detection"])
def test_estimator_loss_skips_non_finite_boxes(where):
    """Boxes whose decoded sizes overflowed (inf, 1e17, 1e38: what a
    diverged detector gave in the slots of an ActiveTrainer epoch) leave the
    loss, the gradient and the weights after an Adam step finite: each such
    slot adds 0 and the rest equal JAX's weighted mean over the finite
    boxes. ``with_detection``: the overflowed box is a detection, and drops
    out of the mean's count too."""
    pts, valid, boxes = _pool_cloud(5)
    pts[:, 3] = 0.5  # an intensity that leaves the output sigmoid unsaturated
    det_valid = np.array([[True, True, False, True, False, True, True, False]])
    bad = np.array([[False, False, True, False, True, False, False, True]])
    if where == "with_detection":
        bad[0, 5] = True
    rng = np.random.RandomState(6)
    target = rng.uniform(0, 1, (1, 8)).astype(np.float32)
    broken = boxes[None].copy()
    broken[bad, 3:6] = [7.8e-8, 1.27e17, np.inf]
    broken[0, 7, 3:6] = [1e38, 1e38, 2.0]
    target_b = np.where(bad, np.nan, target).astype(np.float32)

    def run(bx, tg, loss_fn):
        est = te.init_estimator_(te.Estimator(MAX_PTS, HIDDEN), torch.Generator().manual_seed(1))
        opt = Adam(LR).init(est.named_parameters())
        opt.zero_grad()
        loss = loss_fn(est, t(pts[None]), t(valid[None]), t(bx), t(det_valid), t(tg))
        loss.backward()
        grads = torch.cat([p.grad.flatten() for p in est.parameters()])
        opt.step()
        return float(loss.detach()), grads, torch.cat([p.detach().flatten()
                                                       for p in est.parameters()])

    def jax_formula(est, p, v, bx, dv, tg):  # active_trainer.py's loss_fn in JAX
        w = torch.from_numpy(det_valid & ~bad).float()
        return (torch.square(est(p, v, bx) - tg) * w).sum() / torch.clamp(w.sum(), min=1.0)

    loss, grads, weights = run(broken, target_b, ta.estimator_loss)
    ref_loss, ref_grads, ref_weights = run(boxes[None], target, jax_formula)
    assert np.isfinite(loss) and torch.isfinite(grads).all() and torch.isfinite(weights).all()
    assert loss == pytest.approx(ref_loss, rel=1e-6)
    assert float((grads - ref_grads).abs().max()) <= 1e-6 * float(ref_grads.norm())
    assert float(ref_grads.norm()) > 0
    torch.testing.assert_close(weights, ref_weights, rtol=0, atol=1e-7)


def _step_cfg():
    """The small config cut to its first two task groups, 48 detections a
    task after NMS (96 slots, of which the step takes 64)."""
    cfg = small_cfg("float32", pre=64, post=48)
    cfg["tasks"] = cfg["tasks"][:2]
    cfg["target_assigner"]["anchor_generators"] = cfg["target_assigner"]["anchor_generators"][:3]
    cfg["test_cfg"]["score_threshold"] = 0.0
    return cfg


def _head_maps(tb, seed=4):
    """Seeded head maps of the 8 x 8 anchor map: scores spread over (0, 1),
    boxes near their anchors."""
    rng = np.random.RandomState(seed)
    preds = []
    for ta in tb.task_anchors:
        nc = ta.num_classes
        preds.append({"box_preds": (rng.randn(2, 8, 8, nc * 2 * 10) * 0.3).astype(np.float32),
                      "cls_preds": (rng.randn(2, 8, 8, nc * 2 * nc) * 2).astype(np.float32)})
    return preds


class _JaxHead:
    """Stands in for JAX's detector in its estimator step: the fixed head
    maps (the detector's own parity is tests/test_torch_raw_points.py's)."""

    def __init__(self, preds):
        self.preds = preds

    def apply(self, variables, points, points_valid, train):
        return {"preds": [{k: jnp.asarray(v) for k, v in p.items()} for p in self.preds]}


class _TorchHead(torch.nn.Module):
    """The same for the port, recording the mode it was called in."""

    def __init__(self, preds):
        super().__init__()
        self.preds, self.modes = preds, []

    def forward(self, points=None, points_valid=None):
        self.modes.append(self.training)
        return {"preds": [{k: t(v) for k, v in p.items()} for p in self.preds]}


@pytest.fixture(scope="module")
def jax_step():
    """JAX's side of one estimator step on fixed head maps: the detections,
    the GT boxes built on them, the estimator's initial params, the targets
    / loss / gradient of the step's loss, and the params after JAX's own
    ``make_estimator_step``."""
    cfg = _step_cfg()
    jb = jax_build(JaxConfig(cfg))
    tb = build_detector(cfg, device="cpu")
    preds = _head_maps(tb)
    jb = dataclasses.replace(jb, model=_JaxHead(preds),
                             test_cfg=dataclasses.replace(jb.test_cfg, score_threshold=0.0))
    pts, valid = small_points(0)
    dets = jax.device_get(jax.jit(lambda: jax_predict(
        jb.model.apply(None, None, None, False)["preds"], jb.task_anchors, jb.box_coder,
        jb.test_cfg))())
    boxes = np.asarray(dets["box3d_lidar"][:, :NUM_BOXES])
    # GT: per task, slightly moved copies of four of the first detections,
    # so that targets spread over (0, 1]
    rng = np.random.RandomState(2)
    gt_boxes, gt_classes = [], []
    for ti in range(len(cfg["tasks"])):
        g = np.zeros((2, 8, 9), np.float32)
        g[..., 3:6] = 1.0
        c = np.zeros((2, 8), np.int32)
        for b in range(2):
            src = boxes[b, 4 * ti + np.arange(4)]
            g[b, :4] = src + rng.uniform(-0.3, 0.3, src.shape).astype(np.float32) * [
                1, 1, 1, 0.3, 0.3, 0.3, 0, 0, 0.5]
            c[b, :4] = 1
        gt_boxes.append(g)
        gt_classes.append(c)

    est = je.Estimator(MAX_PTS, HIDDEN)
    params = est.init(jax.random.PRNGKey(1), jnp.asarray(pts), jnp.asarray(valid),
                      jnp.asarray(boxes))["params"]
    gt_all = jnp.concatenate([jnp.asarray(g) for g in gt_boxes], axis=1)
    gt_valid = jnp.concatenate([jnp.asarray(c) > 0 for c in gt_classes], axis=1)
    target = jax.jit(jax.vmap(lambda d, g, v: jnp.where(v[None, :], jax_iou3d(d, g), 0.0)
                              .max(axis=1)))(jnp.asarray(boxes), gt_all, gt_valid)
    w = jnp.asarray(dets["det_valid"][:, :NUM_BOXES]).astype(jnp.float32)

    def loss_fn(p):
        pred = est.apply({"params": p}, jnp.asarray(pts), jnp.asarray(valid),
                         jnp.asarray(boxes))
        return (jnp.square(pred - target) * w).sum() / jnp.maximum(w.sum(), 1.0)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)

    opt = optax.adam(LR)
    state = EstimatorState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=opt.init(params))
    det_state = TrainState(step=jnp.zeros((), jnp.int32), params={}, batch_stats={},
                           opt_state=None)
    batch = {"points": jnp.asarray(pts), "points_valid": jnp.asarray(valid),
             "gt_boxes": [jnp.asarray(g) for g in gt_boxes],
             "gt_classes": [jnp.asarray(c) for c in gt_classes]}
    new_state, logs = jax_make_estimator_step(jb, est, opt)(state, det_state, batch)
    return dict(preds=preds, dets=dets, gt_boxes=gt_boxes, gt_classes=gt_classes,
                params=jax.device_get(params), target=np.asarray(target), loss=float(loss),
                grads=jax.device_get(grads), step_loss=float(logs["estimator_loss"]),
                new_params=jax.device_get(new_state.params))


def test_estimator_step_matches_jax(jax_step):
    ref = jax_step
    tb = build_detector(_step_cfg(), device="cpu")
    head = _TorchHead(ref["preds"]).train()
    bundle = dataclasses.replace(tb, model=head)
    est = te.Estimator(MAX_PTS, HIDDEN)
    est.load_state_dict(estimator_flax_to_state_dict(ref["params"], est), strict=True)
    pts, valid = small_points(0)
    batch = {"points": pts, "points_valid": valid, "gt_boxes": ref["gt_boxes"],
             "gt_classes": ref["gt_classes"]}
    inputs = ta.estimator_inputs(bundle, batch, NUM_BOXES)
    assert head.modes == [False] and head.training  # eval for the predict, then back

    jv = np.asarray(ref["dets"]["det_valid"][:, :NUM_BOXES])
    np.testing.assert_array_equal(inputs["det_valid"].numpy(), jv)
    assert jv.sum() > 0
    # the valid slots (the others hold whatever the top-k leaves in the
    # suppressed places, which differs between the two top-k's)
    np.testing.assert_allclose(inputs["boxes"].numpy()[jv],
                               np.asarray(ref["dets"]["box3d_lidar"][:, :NUM_BOXES])[jv],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(inputs["target"].numpy()[jv], ref["target"][jv], rtol=0,
                               atol=1e-5)
    assert (ref["target"][jv] > 0.1).sum() >= 6  # targets spread over (0, 1]

    # the loss and its gradient, at JAX's boxes (the port's differ by rounding)
    inputs["boxes"] = t(np.asarray(ref["dets"]["box3d_lidar"][:, :NUM_BOXES]))
    inputs["target"] = t(ref["target"])
    opt = Adam(LR).init(est.named_parameters())
    opt.zero_grad()
    loss = ta.estimator_loss(est, **inputs)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(ref["loss"], rel=1e-5)
    assert ref["step_loss"] == pytest.approx(ref["loss"], rel=1e-6)
    names = [(f"Dense_{i}", p) for i, p in enumerate(
        [f"point_mlp.{j}" for j in range(len(HIDDEN))] + ["fc", "out"])]
    g_ref = np.concatenate([np.concatenate([ref["grads"][f]["kernel"].T.ravel(),
                                            ref["grads"][f]["bias"]]) for f, _ in names])
    params = dict(est.named_parameters())
    g_got = np.concatenate([np.concatenate([params[f"{p}.weight"].grad.numpy().ravel(),
                                            params[f"{p}.bias"].grad.numpy()])
                            for _, p in names])
    norm = np.linalg.norm(g_ref)
    assert norm > 0
    assert np.abs(g_got - g_ref).max() <= 1e-4 * norm

    # one Adam step against JAX's make_estimator_step (optax.adam)
    opt.step()
    for f, p in names:
        for mine, theirs in ((params[f"{p}.weight"].detach().numpy().T,
                              ref["new_params"][f]["kernel"]),
                             (params[f"{p}.bias"].detach().numpy(), ref["new_params"][f]["bias"])):
            g = (ref["grads"][f]["kernel"] if theirs.ndim == 2 else ref["grads"][f]["bias"])
            sel = np.abs(g) > 1e-6
            np.testing.assert_allclose(mine[sel], theirs[sel], rtol=0, atol=1e-6, err_msg=f)


def test_active_trainer_runs_the_estimator_step_after_the_train_step(tmp_path):
    """An ActiveTrainer epoch of the real (small) detector: its iteration
    logs the detector's losses and the estimator's, the estimator's weights
    move, the estimator's predict leaves the batch-norm statistics alone
    (the host voxels in the batch are not used: it predicts on the points),
    and the capacity report is logged once."""
    from dal3d_tpu_torch.solver.optim import OneCycleSchedule, build_optimizer
    from torch_port_utils import small_gt

    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        tb = build_detector(_cfg(), device="cpu")
        est = te.init_estimator_(te.Estimator(MAX_PTS, HIDDEN), torch.Generator().manual_seed(1))
        pts, valid = small_points(0)
        vf, vc, vv = small_voxels(9)
        gt_boxes, gt_classes = small_gt(_cfg(), 0)
        batch = {"points": pts, "points_valid": valid, "voxel_features": vf,
                 "voxel_coords": vc, "voxel_valid": vv, "gt_boxes": gt_boxes,
                 "gt_classes": gt_classes}
        tb.model.train()
        stats = {k: v.clone() for k, v in tb.model.state_dict().items() if "running" in k}
        inputs = ta.estimator_inputs(tb, batch)
        assert tb.model.training and inputs["det_valid"].any()
        assert all(torch.equal(tb.model.state_dict()[k], v) for k, v in stats.items())

        records = []

        class Catch(logging.Handler):
            def emit(self, record):
                records.append(record.getMessage())

        logger = logging.getLogger("test_active_trainer")
        logger.addHandler(Catch())
        logger.setLevel(logging.INFO)
        tr = ta.ActiveTrainer(tb, build_optimizer(OneCycleSchedule(total_steps=4)), est,
                              Adam(LR), str(tmp_path), logger=logger, log_interval=100)
        tr.init_state()
        with pytest.raises(RuntimeError, match="init_estimator"):
            tr.train_epoch([batch])
        tr.init_estimator()
        w0 = est.out.weight.detach().clone()
        stats = tr.train_epoch([dict(batch)])
    finally:
        torch.set_num_threads(n_threads)
    assert tr.step == 1 and tr.estimator_optimizer.count == 1
    assert np.isfinite(stats["loss"]) and np.isfinite(stats["estimator_loss"])
    assert not torch.equal(est.out.weight.detach(), w0)
    assert sum("brick capacities" in m for m in records) == 1
    assert any(m.startswith("[active] epoch 1: loss") for m in records)


def test_capacity_report_reads_the_banded_caps():
    """Levels 1-4 from the downsample plans equal the post-compaction
    counts of the model's own forward; level 0 is the uncapped demand, JAX's
    ``count_active_bricks``; a cap at the demand is flagged saturated."""
    from dal3d_tpu.ops.sparse_brick import count_active_bricks as jax_count
    from dal3d_tpu_torch.runtime.capacity import brick_capacity_report, level_counts

    cfg = _cfg()
    cfg["model"]["backbone"]["banded_caps"] = (400, 300, 768, 384, 384)
    tb = build_detector(cfg, device="cpu")
    vf, vc, vv = small_voxels(0)
    with torch.no_grad():
        out = tb.model(t(vf), t(vc), t(vv))
    counts = level_counts(tb.model.backbone, t(vc), t(vv))
    assert [c.tolist() for c in counts[1:]] == [
        (m.brick_lin < m.num_cells).sum(-1).tolist() for m in out["middle"]]
    want0 = np.asarray(jax_count(jnp.asarray(vc), jnp.asarray(vv), (41, 64, 64), 8))
    np.testing.assert_array_equal(counts[0].numpy(), want0)
    rows = brick_capacity_report(tb, {"voxel_features": vf, "voxel_coords": vc,
                                      "voxel_valid": vv})
    assert [r["cap"] for r in rows] == [400, 300, 768, 384, 384]
    assert rows[0]["active"] == int(want0.max()) > 400 and rows[0]["saturated"]
    assert rows[1]["active"] == 300 and rows[1]["saturated"]  # the list is full
    assert not any(r["saturated"] for r in rows[2:])
    # a batch of raw points gives no report, as in JAX
    pts, valid = small_points(0)
    assert brick_capacity_report(tb, {"points": pts, "points_valid": valid}) == []


def test_runtime_utils(tmp_path, capsys):
    """tb_logger opens its writer only when it logs (a no-op without
    tensorboard) and writes without importing TensorFlow; Timer; collect_env
    names torch and the card, not JAX."""
    tf_before = "tensorflow" in sys.modules
    from dal3d_tpu_torch.runtime.tb_logger import TensorboardLogger
    from dal3d_tpu_torch.utils.collect_env import collect_env
    from dal3d_tpu_torch.utils.timer import Timer

    tbl = TensorboardLogger(str(tmp_path))
    assert tbl._w is None and not tbl._tried
    tbl.log({"loss": 1.5, "name": "not a number"}, 3)
    if tbl.active:  # tensorboard installed: events written, TensorFlow not imported
        tbl.close()
        assert any(f.startswith("events.out.tfevents") for f in os.listdir(tmp_path))
        assert "tensorflow" not in sys.modules or tf_before
    with Timer("took", "{:.1f}s") as tm:
        assert tm.since_start() >= 0
    assert capsys.readouterr().out.startswith("took ")
    with pytest.raises(RuntimeError):
        Timer().since_start()
    env = collect_env()
    assert env["torch"] == torch.__version__ and "cuda available" in env
    assert not any("jax" in k.lower() for k in env)
