"""Port parity for the slice as a whole: one lidar-only BEVFusion train step
of dal3d_tpu_torch (train-mode forward, Hungarian-matched TransFusion loss,
backward through the gather engine, clip, AdamW) against dal3d_tpu's
``make_bevfusion_train_step`` on the same host voxels, GT boxes and weights,
on the CPU; the port's dropout. The training CLI is in
tests/test_torch_bevfusion_cli.py.

The model is the tiny one of tests/test_torch_bevfusion.py (TINY, a (41, 64,
64) grid), B=2, 5 and 6 GT boxes of 8 slots. Dropout is off on both sides:
JAX's masks come from JAX's generator and cannot be matched, so the JAX
module's ``nn.Dropout`` is swapped for the identity inside the fixture (a
test-local patch of flax's class; nothing in dal3d_tpu changes) and the
port's ``Dropout`` gets p = 0. Required: the logs within 1e-4 relative
(num_matched equal), every batch-norm running statistic within 1e-5, and
every parameter after the AdamW step within 1e-5 of its scale; Adam's first
update is sign-like (m / (sqrt(v) + eps) = +-1 wherever |g| >> eps), so where
JAX's gradient is at rounding-noise level (below 1e-4 of its tensor's
largest; and the biases of ``ZERO_GRAD``, whose true gradient is 0) the two
may step 2 lr apart, and only there. Each
parameter's gradient is also held to jax.grad of the same loss within 1e-3
of its scale."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.models.bevfusion import BEVFusion as JaxBEVFusion
from dal3d_tpu.models.bevfusion import TransFusionTestCfg as JaxTestCfg
from dal3d_tpu.ops.voxelize import VoxelConfig as JaxVoxelConfig
from dal3d_tpu.runtime.bevfusion_steps import make_bevfusion_train_step as jax_train_step
from dal3d_tpu.runtime.steps import TrainState
from dal3d_tpu.solver import optim as jo
from dal3d_tpu_torch.models.bevfusion.transfusion import Dropout
from dal3d_tpu_torch.models.builder import bevfusion_optimizer, build_bevfusion
from dal3d_tpu_torch.models.convert_flax import bevfusion_flax_to_state_dict, load_flax_bevfusion
from dal3d_tpu_torch.runtime.bevfusion_steps import dropout_generator, make_bevfusion_train_step
from test_torch_bevfusion import TINY, VG, _randomize, tiny_cfg
from torch_port_utils import small_voxels

LOGS = ("loss", "cls_loss", "reg_loss", "heatmap_loss", "seg_loss", "num_matched", "grad_norm")
ONE_CYCLE = dict(lr_max=1e-4, total_steps=10)
# biases whose gradient is 0 in exact arithmetic: in front of a train-mode
# batch norm (the positional encoders' fc1: the norm subtracts the mean), and
# the attention keys' (a bias on every key shifts a query's logits by one
# constant, which the softmax removes), and the last LayerNorm's (its output
# feeds only bias-free dense layers in front of batch norms)
ZERO_GRAD = ("posembed.fc1.bias", "attn.key.bias", "norm3.bias")


class _NoDropout(fnn.Module):
    """The identity in place of flax's ``nn.Dropout`` (same call form)."""

    rate: float
    deterministic: bool = False

    def __call__(self, x):
        return x


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """The lane runs several workers side by side: a full set of intra-op
    threads in each makes them fight for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch():
    vf, vc, vv = small_voxels(0, N=1800)
    rng = np.random.RandomState(5)
    gb = np.zeros((2, 8, 9), np.float32)
    gb[..., 3:6] = 1.0
    gc = np.zeros((2, 8), np.int32)
    for b in range(2):
        for k in range(5 + b):
            gb[b, k] = [rng.uniform(-5.5, 5.5), rng.uniform(-5.5, 5.5), rng.uniform(-1, 0.5),
                        rng.uniform(0.5, 4.5), rng.uniform(0.5, 4.5), rng.uniform(1, 2),
                        rng.uniform(-1, 1), rng.uniform(-1, 1), rng.uniform(-3, 3)]
            gc[b, k] = rng.randint(1, 11)
    return {"voxel_features": vf, "voxel_coords": vc, "voxel_valid": vv, "gt_boxes": gb,
            "gt_classes": gc}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's side: the seeded variables and one step of its jitted train
    step (logs, new params, new batch statistics, gradient norm)."""
    vcfg = JaxVoxelConfig(tuple(VG["range"]), tuple(VG["voxel_size"]), 10, VG["max_voxel_num"])
    model = JaxBEVFusion(voxel_cfg=vcfg, with_camera=False, **TINY)
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    mb = {k: batch[k] for k in ("voxel_features", "voxel_coords", "voxel_valid")}
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), mb, False))
    variables = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes),
                           np.random.RandomState(7))
    opt = jo.build_optimizer(jo.OneCycleSchedule(**ONE_CYCLE))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]),
                       opt_state=opt.init(params))
    tcfg = JaxTestCfg(out_size_factor=8, voxel_size=(0.2, 0.2), pc_range=(-6.4, -6.4))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn, "Dropout", _NoDropout)
        grads = jax.jit(jax.grad(lambda p: _jax_loss(model, tcfg, p, variables, batch)))(params)
        grads = _np(grads)  # before the step, which donates (deletes) its state
        new, logs = jax_train_step(model, opt, tcfg)(state, batch)
    return dict(variables=variables, logs={k: float(v) for k, v in logs.items()},
                new={"params": _np(new.params), "batch_stats": _np(new.batch_stats)},
                grads=grads)


def _jax_loss(model, tcfg, params, variables, batch):
    from dal3d_tpu.models.bevfusion.transfusion import transfusion_loss

    mb = {k: batch[k] for k in ("voxel_features", "voxel_coords", "voxel_valid")}
    preds, _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]}, mb, True,
                           mutable=["batch_stats"])
    return transfusion_loss(preds, batch["gt_boxes"], batch["gt_classes"], tcfg)["loss"]


def _max(x: torch.Tensor) -> float:
    return float(x.max()) if x.numel() else 0.0


def _port(variables, p_drop=0.0):
    bundle = build_bevfusion(tiny_cfg(), device="cpu")
    load_flax_bevfusion(bundle.model, variables)
    for m in bundle.model.modules():
        if isinstance(m, Dropout):
            m.p = p_drop
    opt = bevfusion_optimizer(tiny_cfg(), bundle, ONE_CYCLE["total_steps"])
    return bundle, opt, make_bevfusion_train_step(bundle, opt)


def test_train_step_matches_jax(jax_ref):
    variables = jax_ref["variables"]
    bundle, opt, step = _port(variables)
    grads_at = {}
    for n, p in bundle.model.named_parameters():
        p.register_hook(lambda g, n=n: grads_at.__setitem__(n, g.clone()))
    logs = {k: float(v) for k, v in step(_batch()).items()}
    ref = jax_ref["logs"]
    assert set(logs) == set(LOGS) and opt.count == 1
    assert logs["num_matched"] == ref["num_matched"] == 11
    for k in LOGS:
        assert logs[k] == pytest.approx(ref[k], rel=1e-4, abs=1e-12), k
    assert ref["grad_norm"] > 35.0  # the clip is active

    model = bundle.model
    # every norm ran on batch statistics and moved its running ones, with
    # JAX's momenta (the encoder's and SECOND's 0.99, the head's 0.9, flax's
    # convention)
    before = bevfusion_flax_to_state_dict(variables, model)
    moved = [k for k, v in model.state_dict().items()
             if "running" in k and float((v - before[k]).abs().max()) > 0]
    assert len(moved) == 72
    assert model.encoder.stem_bn.momentum == 0.01 and model.head.heatmap_bn.momentum == 0.1
    new = bevfusion_flax_to_state_dict(jax_ref["new"], model)
    grads = bevfusion_flax_to_state_dict({"params": jax_ref["grads"],
                                          "batch_stats": jax_ref["new"]["batch_stats"]}, model)
    sd = model.state_dict()
    lr = opt.lr_fn(0)
    n_stats = n_apart = n_zero = 0
    for k, v in new.items():
        got = sd[k]
        if "running" in k:
            np.testing.assert_allclose(got.numpy(), v.numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
            n_stats += 1
            continue
        scale = float(v.abs().max())
        err = (got - v).abs()
        g = grads[k].abs()
        gp = grads_at[k]  # the port's gradient of the same parameter
        if k.endswith(ZERO_GRAD):
            # no gradient in exact arithmetic: rounding noise on both sides
            w_scale = float(grads[k[:-4] + "weight"].abs().max())
            assert float(g.max()) <= 1e-5 * w_scale and float(gp.abs().max()) <= 1e-5 * w_scale
            assert float(err.max()) <= 2.0001 * lr, k
            n_zero += 1
            continue
        noise = g <= 1e-4 * float(g.max())
        assert _max(err[~noise]) <= 1e-5 * scale, (k, _max(err[~noise]), scale)
        assert _max(err[noise]) <= 2.0001 * lr, k
        n_apart += int((err[noise] > 1e-5 * scale).sum())
        assert float((gp - grads[k]).abs().max()) <= 1e-3 * float(g.max()) + 1e-9, k
    assert n_stats == 2 * 36 and n_zero == 5 and n_apart <= 20, n_apart


def test_dropout_rate_scaling_eval_and_redraw():
    """The port's dropout: about p of the values dropped, the kept ones
    scaled by 1 / (1 - p), the identity in eval mode, and the same mask again
    from a generator seeded with the same step (a resumed run redraws what
    the first run drew); another step draws another mask."""
    d = Dropout(0.1).train()
    x = torch.ones(200, 500)
    d.generator = dropout_generator("cpu", 7)
    y = d(x)
    kept = y != 0
    assert abs(1 - float(kept.float().mean()) - 0.1) < 0.005
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.9))
    d.generator = dropout_generator("cpu", 7)
    assert torch.equal(d(x), y)
    d.generator = dropout_generator("cpu", 8)
    assert not torch.equal(d(x), y)
    assert torch.equal(d.eval()(x), x)
