"""Port parity of the TransFusion loss and its targets
(dal3d_tpu_torch/models/bevfusion/{gaussian,transfusion}.py) against the
JAX package on the CPU.

- ``gaussian_radius`` bit-equal to JAX's run op by op (jitted, XLA's CPU
  compiler contracts its multiply-adds into FMAs, which moves a last bit);
- ``draw_gaussian_heatmap``: the same cells lit, values within one f32 ulp
  (the two libraries' ``exp`` differ in the last bit on some inputs), the
  scatter-max bit-equal on a repeat;
- ``gaussian_focal_loss`` within 1e-6 of scale;
- ``transfusion_loss`` on the same predictions and padded GT (with a class
  of every task, boxes near the proposals so that the IoU cost matters):
  the Hungarian assignment (JAX's col4row, recorded through a debug
  callback) and num_matched equal, the four losses within 1e-5 relative, and
  the gradient with respect to every prediction within 1e-4 of the whole
  gradient's norm (jax.value_and_grad)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dal3d_tpu.ops.lsa as jax_lsa_module
from dal3d_tpu.models.bevfusion import gaussian as jg
from dal3d_tpu.models.bevfusion.transfusion import TransFusionTestCfg as JaxTestCfg
from dal3d_tpu.models.bevfusion.transfusion import transfusion_loss as jax_loss
from dal3d_tpu_torch.models.bevfusion import gaussian as tgs
from dal3d_tpu_torch.models.bevfusion.transfusion import TransFusionTestCfg, transfusion_loss
from torch_port_utils import t

B, P, G, NC, H, W = 2, 24, 12, 10, 16, 16
CFG = dict(out_size_factor=8, voxel_size=(0.2, 0.2), pc_range=(-12.8, -12.8))
KEYS = ("center", "height", "dim", "rot", "vel", "cls_logits", "heatmap")


def test_gaussian_radius_bit_equal():
    rng = np.random.RandomState(0)
    length = rng.uniform(0.3, 30, (4, 50)).astype(np.float32)
    width = rng.uniform(0.2, 12, (4, 50)).astype(np.float32)
    with jax.disable_jit():
        ref = np.asarray(jg.gaussian_radius(jnp.asarray(length), jnp.asarray(width), 0.1))
    got = tgs.gaussian_radius(t(length), t(width), 0.1).numpy()
    np.testing.assert_array_equal(got, ref)


def test_gaussian_heatmap_and_focal_loss():
    rng = np.random.RandomState(1)
    Bh, Gh, Hh, Wh, nc = 2, 30, 40, 48, 10
    cen = rng.uniform(-3, 50, (Bh, Gh, 2)).astype(np.float32)
    rad = rng.randint(2, 14, (Bh, Gh)).astype(np.int32)  # 13: past rmax, clipped to 12
    cls = rng.randint(0, nc, (Bh, Gh)).astype(np.int32)
    val = rng.rand(Bh, Gh) < 0.8
    with jax.disable_jit():
        ref = np.asarray(jg.draw_gaussian_heatmap(*map(jnp.asarray, (cen, rad, cls, val)),
                                                  Hh, Wh, nc))
    args = tuple(map(t, (cen, rad, cls, val)))
    got = tgs.draw_gaussian_heatmap(*args, Hh, Wh, nc).numpy()
    assert got.shape == (Bh, Hh, Wh, nc)
    np.testing.assert_array_equal(got > 0, ref > 0)
    np.testing.assert_array_equal(got == 1.0, ref == 1.0)
    assert np.all(np.abs(got - ref) <= np.spacing(np.maximum(np.abs(ref), 1e-30)))
    assert np.array_equal(tgs.draw_gaussian_heatmap(*args, Hh, Wh, nc).numpy(), got)
    logits = (rng.randn(Bh, Hh, Wh, nc) * 3).astype(np.float32)
    fl = tgs.gaussian_focal_loss(t(logits), t(ref)).numpy()
    fr = np.asarray(jax.jit(jg.gaussian_focal_loss)(logits, ref))
    assert np.abs(fl - fr).max() <= 1e-6 * np.abs(fr).max()


def _case():
    """Predictions near a padded GT set: proposals 0-9 sit on GT boxes (noisy
    centres, sizes, yaw), the others anywhere; GT classes over 1..10, the
    last slots padding (and one box outside the heatmap)."""
    rng = np.random.RandomState(2)
    gt = np.zeros((B, G, 9), np.float32)
    gt[..., 3:6] = 1.0
    gcls = np.zeros((B, G), np.int32)
    for b in range(B):
        n = 8 + b
        gt[b, :n, :2] = rng.uniform(-11, 11, (n, 2))
        gt[b, :n, 2] = rng.uniform(-1.5, 0.5, n)
        gt[b, :n, 3:6] = rng.uniform(0.5, 4.5, (n, 3))
        gt[b, :n, 6:8] = rng.uniform(-2, 2, (n, 2))
        gt[b, :n, 8] = rng.uniform(-3, 3, n)
        gcls[b, :n] = rng.randint(1, NC + 1, n)
    gt[1, 8, :2] = (20.0, 3.0)  # outside the heatmap: no gaussian, still matched
    f, vs, pc = CFG["out_size_factor"], CFG["voxel_size"][0], CFG["pc_range"][0]
    center = rng.uniform(0, W, (B, P, 2)).astype(np.float32)
    center[:, :10] = (gt[:, :10, :2] - pc) / (f * vs) + rng.randn(B, 10, 2) * 0.2
    dim = rng.randn(B, P, 3).astype(np.float32) * 0.5
    dim[:, :10] = np.log(gt[:, :10, 3:6]) + rng.randn(B, 10, 3) * 0.1
    height = rng.randn(B, P, 1).astype(np.float32)
    height[:, :10, 0] = gt[:, :10, 2] + gt[:, :10, 5] / 2 + rng.randn(B, 10) * 0.1
    yaw = rng.uniform(-3, 3, (B, P))
    yaw[:, :10] = gt[:, :10, 8] + rng.randn(B, 10) * 0.2
    preds = {"center": center, "height": height, "dim": dim,
             "rot": np.stack([np.cos(yaw), np.sin(yaw)], -1) * 0.9,
             "vel": rng.randn(B, P, 2), "cls_logits": rng.randn(B, P, NC) * 2,
             "heatmap": rng.randn(B, H, W, NC) * 2}
    preds = {k: np.asarray(v, np.float32) for k, v in preds.items()}
    preds["query_labels"] = rng.randint(0, NC, (B, P)).astype(np.int32)
    preds["query_score"] = rng.rand(B, P).astype(np.float32)
    return preds, gt, gcls


@pytest.fixture(scope="module")
def jax_ref():
    preds, gt, gcls = _case()
    cfg = JaxTestCfg(**CFG)
    recorded = []
    orig = jax_lsa_module.linear_sum_assignment

    def record(cost):
        out = orig(cost)
        jax.debug.callback(lambda v: recorded.append(np.asarray(v)), out)
        return out

    fixed = {k: jnp.asarray(v) for k, v in preds.items() if k not in KEYS}

    def loss(p):
        logs = jax_loss({**p, **fixed}, jnp.asarray(gt), jnp.asarray(gcls), cfg)
        return logs["loss"], logs

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_lsa_module, "linear_sum_assignment", record)
        (_, logs), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            {k: jnp.asarray(preds[k]) for k in KEYS})
        jax.effects_barrier()
    return (preds, gt, gcls, {k: float(v) for k, v in logs.items()},
            {k: np.asarray(v) for k, v in grads.items()}, np.stack(recorded))


def test_transfusion_loss_matches_jax(jax_ref):
    preds, gt, gcls, ref, ref_grads, col4row = jax_ref
    tp = {k: t(v).requires_grad_(k in KEYS) for k, v in preds.items()}
    logs = transfusion_loss(tp, t(gt), t(gcls), TransFusionTestCfg(**CFG))
    assert col4row.shape == (B, G)
    for b in range(B):  # the same Hungarian assignment
        for g in range(G):
            p = int(col4row[b, g])
            want = g if gcls[b, g] > 0 else -1
            if want >= 0:
                assert int(logs["assign"][b, p]) == want, (b, g, p)
    assert int(logs["num_matched"]) == ref["num_matched"] == int((gcls > 0).sum())
    for k in ("loss", "cls_loss", "reg_loss", "heatmap_loss"):
        assert float(logs[k]) == pytest.approx(ref[k], rel=1e-5), k
    logs["loss"].backward()
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in ref_grads.values()))
    for k in KEYS:
        err = float(np.abs(tp[k].grad.numpy() - ref_grads[k]).max())
        assert err <= 1e-4 * norm, (k, err, norm)
    assert float(np.abs(ref_grads["heatmap"]).max()) > 0 and float(
        np.abs(ref_grads["center"]).max()) > 0
