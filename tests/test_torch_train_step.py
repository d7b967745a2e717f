"""Port parity for the slice as a whole: one CBGS train step of
dal3d_tpu_torch (forward in train mode, on-device target assignment, loss,
banded backward, clip, AdamW) against dal3d_tpu's on the same host voxels, GT
boxes and weights.

The config is the production CBGS one cut to a 12.8 m grid
(tests/torch_port_utils.py::small_cfg), f32, B=2, one GT box per task and
sample. JAX runs on the CPU through the XLA branch of its banded backward.
Weights are seeded numpy values carried across by models/convert_flax.py;
batch statistics start fresh (mean 0, var 1).

f32: loss and the five logs within 1e-4 relative, every parameter's gradient
within 1e-3 of its scale (the conv biases in front of a batch norm have none:
both are held to zero), the updated batch statistics within 1e-5, and the
loss of three steps on the same batch within 1e-3 relative. Updated weights
are not compared one by one: Adam's first updates are sign-like
(m / (sqrt(v) + eps) = +-1 wherever |g| >> eps), so a gradient at noise level
flips an update by 2 lr between the packages; the optimizer alone is held
tightly in tests/test_torch_optim.py. bf16: JAX's CPU runtime cannot run its
bf16 banded path, so the port's bf16 step is held to JAX's f32 step loosely.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.models.builder import build_detector as jax_build
from dal3d_tpu.models.heads.mg_head import multi_group_loss as jax_multi_group_loss
from dal3d_tpu.runtime.steps import TrainState
from dal3d_tpu.runtime.steps import make_train_step as jax_make_train_step
from dal3d_tpu.solver import optim as jo
from dal3d_tpu.utils.config import Config as JaxConfig
from dal3d_tpu_torch.models.builder import build_detector
from dal3d_tpu_torch.models.convert_flax import flax_to_state_dict, load_flax_variables
from dal3d_tpu_torch.runtime.steps import make_predict_step, make_train_step
from dal3d_tpu_torch.solver import optim as to
from test_torch_predict import _randomize
from torch_port_utils import small_cfg, small_gt, small_voxels

ONE_CYCLE = dict(lr_max=0.002, moms=(0.95, 0.85), div_factor=10.0, pct_start=0.4, total_steps=100)
LOGS = ("loss", "grad_norm", "num_pos", "loc_loss", "cls_loss")
STEPS = 3
# the port's bf16 step against JAX's f32 step: loss and its parts within this
# share (found: 1.1e-2 on the loss, 2.4e-2 on the gradient norm)
BF16_TOL = 5e-2


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def _batch():
    cfg = small_cfg("float32")
    vf, vc, vv = small_voxels(0)
    gt_boxes, gt_classes = small_gt(cfg, 0)
    return {"voxel_features": vf, "voxel_coords": vc, "voxel_valid": vv,
            "gt_boxes": gt_boxes, "gt_classes": gt_classes}


def _fresh_stats(tree):
    return {k: _fresh_stats(v) if isinstance(v, dict)
            else (np.ones if k == "var" else np.zeros)(np.shape(v), np.float32)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's side: the variables, the gradients and new batch statistics of
    the first step (jax.value_and_grad of the step's loss), and the logs of
    STEPS steps of JAX's own make_train_step on one batch."""
    cfg = small_cfg("float32")
    jb = jax_build(JaxConfig(cfg))
    nb = _batch()
    batch = {k: [jnp.asarray(x) for x in v] if isinstance(v, list) else jnp.asarray(v)
             for k, v in nb.items()}
    batch["points"] = jnp.zeros((2, 1, 5), jnp.float32)
    batch["points_valid"] = jnp.zeros((2, 1), bool)
    voxels = (batch["voxel_features"], batch["voxel_coords"], batch["voxel_valid"])
    shapes = jax.eval_shape(lambda: jb.model.init(
        jax.random.PRNGKey(0), batch["points"], batch["points_valid"], False, voxels=voxels))
    variables = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape), shapes),
                           np.random.RandomState(1))
    variables["batch_stats"] = _fresh_stats(variables["batch_stats"])

    def loss_fn(params, batch_stats):
        out, new_state = jb.model.apply(
            {"params": params, "batch_stats": batch_stats}, batch["points"],
            batch["points_valid"], True, voxels=voxels, mutable=["batch_stats"])
        labels, targets, _ = jb.assigner.assign_all(batch["gt_boxes"], batch["gt_classes"])
        logs = jax_multi_group_loss(out["preds"], labels, targets, jb.num_classes, jb.loss_cfg)
        return logs["loss"], new_state["batch_stats"]

    (loss, new_stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"])

    optimizer = jo.build_optimizer(jo.OneCycleSchedule(**ONE_CYCLE), weight_decay=0.01,
                                   grad_clip_norm=35.0)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                       opt_state=optimizer.init(params))
    step = jax_make_train_step(jb, optimizer)
    logs = []
    for _ in range(STEPS):
        state, lg = step(state, batch)
        logs.append({k: float(v) for k, v in lg.items()})
    return dict(variables=variables, loss=float(loss), grads=_np_tree(grads),
                new_stats=_np_tree(new_stats), logs=logs,
                final_stats=_np_tree(state.batch_stats))


def _port(variables, dtype):
    tb = build_detector(small_cfg(dtype), device="cpu")
    load_flax_variables(tb.model, variables)
    opt = to.build_optimizer(to.OneCycleSchedule(**ONE_CYCLE), weight_decay=0.01,
                             grad_clip_norm=35.0).init(tb.model.named_parameters())
    return tb, opt, make_train_step(tb, opt)


def test_fresh_flax_state_round_trips(jax_ref):
    """The bridge carries a flax tree with fresh batch statistics and no
    optimizer state: every parameter and buffer of the port's model is
    covered, values arrive unchanged (kernels up to their layout), and the
    fresh statistics are the port's own defaults."""
    variables = jax_ref["variables"]
    tb = build_detector(small_cfg("float32"), device="cpu")
    sd = flax_to_state_dict(variables, tb.model)
    assert set(sd) == set(tb.model.state_dict())
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    assert len(sd) == n_leaves
    total = sum(float(np.abs(x).sum()) for x in jax.tree_util.tree_leaves(variables))
    assert sum(float(v.abs().sum()) for v in sd.values()) == pytest.approx(total, rel=1e-6)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            assert float(v.abs().max()) == 0.0
        if k.endswith("running_var"):
            assert float((v - 1).abs().max()) == 0.0
    assert sum(k.endswith("running_var") for k in sd) == 35  # 21 sparse + 14 dense norms


def test_train_step_matches_jax_f32(jax_ref):
    variables = jax_ref["variables"]
    tb, opt, step = _port(variables, "float32")
    batch = _batch()
    logs = [{k: float(v) for k, v in step(batch).items()}]
    ref = jax_ref["logs"]
    assert ref[0]["loss"] == pytest.approx(jax_ref["loss"], rel=1e-5)
    assert ref[0]["num_pos"] == logs[0]["num_pos"] >= 12
    assert ref[0]["grad_norm"] > 35.0  # the clip is active
    for k in LOGS:
        assert logs[0][k] == pytest.approx(ref[0][k], rel=1e-4), k

    # gradients of the first step, parameter by parameter
    grads = flax_to_state_dict({"params": jax_ref["grads"],
                                "batch_stats": variables["batch_stats"]}, tb.model)
    named = dict(tb.model.named_parameters())
    grads = {k: g for k, g in grads.items() if "running" not in k}
    assert set(grads) == set(named)
    for k, g in grads.items():
        scale = float(g.abs().max())
        if k.endswith(("conv1.bias", "conv2.bias")):
            # a bias in front of a train-mode batch norm has no gradient (the
            # norm subtracts the mean): rounding noise in both packages
            w_scale = float(grads[k[:-4] + "weight"].abs().max())
            assert scale <= 1e-5 * w_scale and float(named[k].grad.abs().max()) <= 1e-5 * w_scale, k
            continue
        assert scale > 0, k
        err = float((named[k].grad - g).abs().max())
        assert err <= 1e-3 * scale, (k, err, scale)

    # batch statistics after the first step
    stats = flax_to_state_dict({"params": variables["params"],
                                "batch_stats": jax_ref["new_stats"]}, tb.model)
    sd = tb.model.state_dict()
    moved = 0
    for k, v in stats.items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
            moved += float((v - (1.0 if k.endswith("var") else 0.0)).abs().max()) > 1e-4
    assert moved >= 60  # the statistics really moved off their fresh values

    # the loss over three steps on the same batch
    for _ in range(STEPS - 1):
        logs.append({k: float(v) for k, v in step(batch).items()})
    for a, b in zip(logs, ref):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-3)
        assert a["num_pos"] == b["num_pos"]
    assert logs[-1]["loss"] < logs[0]["loss"]
    assert opt.count == STEPS
    final = flax_to_state_dict({"params": variables["params"],
                                "batch_stats": jax_ref["final_stats"]}, tb.model)
    sd = tb.model.state_dict()
    for k, v in final.items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-3, atol=1e-3, err_msg=k)


def test_train_step_bf16_close_to_jax_f32(jax_ref):
    tb, _, step = _port(jax_ref["variables"], "bfloat16")
    batch = _batch()
    batch["voxel_features"] = torch.from_numpy(batch["voxel_features"]).to(torch.bfloat16)
    logs = {k: float(v) for k, v in step(batch).items()}
    ref = jax_ref["logs"][0]
    assert logs["num_pos"] == ref["num_pos"]
    for k in ("loss", "loc_loss", "cls_loss", "grad_norm"):
        assert logs[k] == pytest.approx(ref[k], rel=BF16_TOL), k
    named = dict(tb.model.named_parameters())
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in named.values())
    assert named["backbone.l0.stem.weight"].grad.dtype == torch.float32


def test_predict_after_train_step_uses_running_statistics(jax_ref):
    """A trainer holds both steps: the predict step switches to eval mode and
    leaves the running statistics alone; the next train step switches back."""
    tb, _, step = _port(jax_ref["variables"], "float32")
    batch = _batch()
    step(batch)
    assert tb.model.training
    before = {k: v.clone() for k, v in tb.model.state_dict().items() if "running" in k}
    out = make_predict_step(tb)(batch)
    assert not tb.model.training and bool(torch.isfinite(out["embedding"]).all())
    after = tb.model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    step(batch)
    assert tb.model.training
