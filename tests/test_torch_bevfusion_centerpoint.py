"""Port parity of BEVFusion with the CenterPoint head and map
segmentation, on the CPU: the tiny model of tests/test_torch_bevfusion.py (a
(41, 64, 64) grid, an 8 x 8 neck map) with ``head="centerpoint"`` (JAX's
default task groups (1, 2, 2, 1, 2, 2)) and ``with_map_seg=True``, built
through ``build_bevfusion`` and given JAX's numpy-randomised variables
through ``load_flax_bevfusion`` (strict both ways). One jitted JAX forward.

Required: every task's ``center_preds``, ``seg_logits`` and ``bev_feat``
within 1e-4 of scale; the bundle's ``CenterTestCfg`` from the config's
test_cfg; the BEVFusion steps refuse a CenterPoint model with ROADMAP C.4
(JAX's steps have no CenterPoint path). The head's decode and loss are held
in tests/test_torch_bevfusion_heads.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.models.bevfusion import BEVFusion as JaxBEVFusion
from dal3d_tpu.ops.voxelize import VoxelConfig as JaxVoxelConfig
from dal3d_tpu_torch.models.bevfusion.centerpoint import CenterTestCfg
from dal3d_tpu_torch.models.builder import bevfusion_optimizer, build_bevfusion
from dal3d_tpu_torch.models.convert_flax import bevfusion_flax_to_state_dict, load_flax_bevfusion
from dal3d_tpu_torch.runtime.bevfusion_steps import (make_bevfusion_predict_step,
                                                     make_bevfusion_train_step)
from test_torch_bevfusion import TINY, VG, _randomize, tiny_cfg
from test_torch_camera_branch import few_threads  # noqa: F401
from torch_port_utils import small_voxels

pytestmark = pytest.mark.usefixtures("few_threads")

@pytest.fixture(scope="module")
def jax_ref():
    vcfg = JaxVoxelConfig(tuple(VG["range"]), tuple(VG["voxel_size"]), 10, VG["max_voxel_num"])
    model = JaxBEVFusion(voxel_cfg=vcfg, with_camera=False, head="centerpoint",
                         with_map_seg=True, **TINY)
    vf, vc, vv = small_voxels(0, N=1800)
    mb = {"voxel_features": jnp.asarray(vf), "voxel_coords": jnp.asarray(vc),
          "voxel_valid": jnp.asarray(vv)}
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), mb, False))
    variables = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes),
                           np.random.RandomState(11))
    preds = jax.jit(lambda v, b: model.apply(v, b, False))(variables, mb)
    return dict(vc=variables, preds=jax.tree_util.tree_map(np.array, preds))


def _close(got, ref, rel=1e-4, name=""):
    got = got.detach().float().numpy()
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert got.shape == ref.shape and err <= rel * scale, (name, err, scale)


def test_centerpoint_and_seg_forward_match_jax(jax_ref):
    bundle = build_bevfusion(tiny_cfg(head="centerpoint", with_map_seg=True), device="cpu")
    model = bundle.model
    assert isinstance(bundle.test_cfg, CenterTestCfg) and bundle.test_cfg.max_per_task == 83
    assert bundle.test_cfg.voxel_size == (0.2, 0.2)
    leaves = len(jax.tree_util.tree_leaves(jax_ref["vc"]))
    assert len(bevfusion_flax_to_state_dict(jax_ref["vc"], model)) == leaves == len(
        model.state_dict())
    load_flax_bevfusion(model, jax_ref["vc"])
    vf, vc, vv = small_voxels(0, N=1800)
    with torch.inference_mode():
        preds = model(torch.from_numpy(vf), torch.from_numpy(vc), torch.from_numpy(vv))
    jp = jax_ref["preds"]
    assert set(preds) == set(jp) == {"center_preds", "seg_logits", "bev_feat"}
    assert len(preds["center_preds"]) == 6
    for i, (p, q) in enumerate(zip(preds["center_preds"], jp["center_preds"])):
        assert set(p) == set(q) == {"heatmap", "reg", "height", "dim", "rot", "vel"}
        for k in p:
            _close(p[k], q[k], name=f"task {i} {k}")
    _close(preds["seg_logits"], jp["seg_logits"], name="seg_logits")
    assert preds["seg_logits"].shape == (2, 8, 8, 6)
    _close(preds["bev_feat"], jp["bev_feat"], name="bev_feat")
    # JAX's steps have no CenterPoint path: the port's refuse it by name
    for make in (make_bevfusion_predict_step,
                 lambda b: make_bevfusion_train_step(b, bevfusion_optimizer(
                     tiny_cfg(), b, 10))):
        with pytest.raises(NotImplementedError, match="C.4"):
            make(bundle)
