"""Port parity of one BEVFusion train step with map segmentation, on the
CPU: the tiny TransFusion model of tests/test_torch_bevfusion.py (a (41, 64,
64) grid, an 8 x 8 neck map) with ``with_map_seg=True`` and 10 x 10 map
targets, so that the step resizes the logits (JAX's antialiased bilinear,
the port's ``ops/resize.py``).

JAX's ``make_bevfusion_train_step`` runs once; its gradient is read back
from the step's AdamW state. Dropout is off on both sides,
as in tests/test_torch_bevfusion_train.py. Required: the step's ``seg_loss``
and ``loss`` (and the TransFusion terms, the gradient norm) within 1e-4
relative; every parameter's gradient within 1e-3 of its scale (the
zero-gradient biases of ``ZERO_GRAD`` at rounding-noise level on both
sides); ``seg_loss`` 0 for a batch without targets. The CenterPoint model is
tests/test_torch_bevfusion_centerpoint.py's."""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dal3d_tpu.models.bevfusion import BEVFusion as JaxBEVFusion
from dal3d_tpu.models.bevfusion import TransFusionTestCfg as JaxTestCfg
from dal3d_tpu.ops.voxelize import VoxelConfig as JaxVoxelConfig
from dal3d_tpu.runtime.bevfusion_steps import make_bevfusion_train_step as jax_train_step
from dal3d_tpu.runtime.steps import TrainState
from dal3d_tpu.solver import optim as jo
from dal3d_tpu_torch.models.bevfusion.transfusion import Dropout
from dal3d_tpu_torch.models.builder import bevfusion_optimizer, build_bevfusion
from dal3d_tpu_torch.models.convert_flax import bevfusion_flax_to_state_dict, load_flax_bevfusion
from dal3d_tpu_torch.runtime.bevfusion_steps import make_bevfusion_train_step
from test_torch_bevfusion import TINY, VG, _randomize, tiny_cfg
from test_torch_bevfusion_train import ONE_CYCLE, ZERO_GRAD, _NoDropout, _batch
from test_torch_camera_branch import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

TCFG = JaxTestCfg(out_size_factor=8, voxel_size=(0.2, 0.2), pc_range=(-6.4, -6.4))
VOXEL_KEYS = ("voxel_features", "voxel_coords", "voxel_valid")


def seg_batch():
    batch = _batch()
    batch["gt_masks_bev"] = (np.random.RandomState(8).rand(2, 10, 10, 6) < 0.3).astype(
        np.float32)
    return batch


def _init(model, mb, seed):
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), mb, False))
    return _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes),
                      np.random.RandomState(seed))


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's train step once (one compile). Its gradient is read back from
    the step's own AdamW state: the first moment after one step is (1 - b1)
    x the clipped gradient, and the clip scaled it by 35 / grad_norm."""
    vcfg = JaxVoxelConfig(tuple(VG["range"]), tuple(VG["voxel_size"]), 10, VG["max_voxel_num"])
    seg = JaxBEVFusion(voxel_cfg=vcfg, with_camera=False, with_map_seg=True, **TINY)
    batch = {k: jnp.asarray(v) for k, v in seg_batch().items()}
    vs = _init(seg, {k: batch[k] for k in VOXEL_KEYS}, 7)
    sched = jo.OneCycleSchedule(**ONE_CYCLE)
    opt = jo.build_optimizer(sched)
    params = jax.tree_util.tree_map(jnp.asarray, vs["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(jnp.asarray, vs["batch_stats"]),
                       opt_state=opt.init(params))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn, "Dropout", _NoDropout)
        new, logs = jax_train_step(seg, opt, TCFG)(state, batch)
    logs = {k: float(v) for k, v in logs.items()}
    mu = new.opt_state[1].inner_state[0].mu
    unclip = (1.0 - float(jo.one_cycle_momentum(sched)(0))) * min(1.0, 35.0 / logs["grad_norm"])
    grads = jax.tree_util.tree_map(lambda m: np.array(m) / unclip, mu)
    return dict(vs=vs, logs=logs, grads=grads)


def test_seg_train_step_matches_jax(jax_ref):
    bundle = build_bevfusion(tiny_cfg(with_map_seg=True), device="cpu")
    load_flax_bevfusion(bundle.model, jax_ref["vs"])
    for m in bundle.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    opt = bevfusion_optimizer(tiny_cfg(), bundle, ONE_CYCLE["total_steps"])
    step = make_bevfusion_train_step(bundle, opt)
    grads_at = {}
    for n, p in bundle.model.named_parameters():
        p.register_hook(lambda g, n=n: grads_at.__setitem__(n, g.clone()))
    logs = {k: float(v) for k, v in step(seg_batch()).items()}
    ref = jax_ref["logs"]
    assert ref["seg_loss"] > 0.1
    for k in ("loss", "seg_loss", "cls_loss", "reg_loss", "grad_norm"):
        assert logs[k] == pytest.approx(ref[k], rel=1e-4), k
    model = bundle.model
    grads = bevfusion_flax_to_state_dict({"params": jax_ref["grads"],
                                          "batch_stats": jax_ref["vs"]["batch_stats"]}, model)
    assert {k for k in grads if "running" not in k} == set(grads_at)
    assert any(k.startswith("seg_head.") for k in grads_at)
    for k, gp in grads_at.items():
        g = grads[k].abs()
        if k.endswith(ZERO_GRAD):  # no gradient in exact arithmetic
            w_scale = float(grads[k[:-4] + "weight"].abs().max())
            assert float(g.max()) <= 1e-5 * w_scale and float(gp.abs().max()) <= 1e-5 * w_scale
            continue
        assert float((gp - grads[k]).abs().max()) <= 1e-3 * float(g.max()) + 1e-9, k
    # without targets the branch is off and seg_loss is logged as 0
    batch = seg_batch()
    del batch["gt_masks_bev"]
    assert float(step(batch)["seg_loss"]) == 0.0
