"""The image backbones and the standalone mean VFE of the PyTorch port
against the JAX package on the CPU: ``ResNet``, ``SENet`` and ``SSDVGG``
(models/backbones/image.py) at narrow widths on weights carried across by
``models/convert_flax.py::image_backbone_flax_to_state_dict``, in eval mode
and in train mode (its maps and the updated running statistics), within
1e-4 of scale in f32; ``VoxelFeatureExtractorV3`` within 1e-6 relative.
JAX's side is one jitted function, run once for the file: weights from
``jax.eval_shape``, drawn with numpy."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.models.backbones.image import ResNet as JResNet
from dal3d_tpu.models.backbones.image import SENet as JSENet
from dal3d_tpu.models.backbones.image import SSDVGG as JSSDVGG
from dal3d_tpu.models.readers.voxel_encoder import VoxelFeatureExtractorV3 as JVFE
from dal3d_tpu_torch.models.backbones.image import SENet, SSDVGG, ResNet
from dal3d_tpu_torch.models.convert_flax import image_backbone_flax_to_state_dict
from dal3d_tpu_torch.models.readers.voxel_encoder import VoxelFeatureExtractorV3
from test_torch_camera_branch import few_threads  # noqa: F401
from torch_port_utils import t

pytestmark = pytest.mark.usefixtures("few_threads")

TOL = 1e-4
# narrow widths: ResNet's stem stays 64 wide (JAX's), SSDVGG's fc6 / fc7 1024
NETS = {
    "resnet": (JResNet, ResNet, dict(stage_blocks=(2, 1, 1, 1), channels=(16, 24, 32, 32))),
    "senet": (JSENet, SENet, dict(stage_blocks=(1, 2, 1, 1), channels=(32, 32, 48, 64))),
    "ssdvgg": (JSSDVGG, SSDVGG, dict(depths=(1, 1, 2, 2, 1), channels=(8, 8, 16, 16, 16))),
}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _weights(shapes, seed):
    """Flax variables of ``jax.eval_shape``'s shapes drawn with numpy:
    kernels at 1/sqrt(fan-in), scales and variances in [0.5, 1.5], biases
    and means near 0."""
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            x = rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        elif "scale" in name or "var" in name:
            x = rng.uniform(0.5, 1.5, s.shape)
        else:
            x = rng.normal(0, 0.1, s.shape)
        return x.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def ref():
    """JAX's side in one jit: each net's eval forward, and its train forward
    with the updated batch statistics, on one [2, 3, 36, 44] image batch."""
    x = np.random.RandomState(0).normal(0, 1, (2, 3, 36, 44)).astype(np.float32)
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    key = jax.random.PRNGKey(0)
    mods = {k: j(**kw) for k, (j, _, kw) in NETS.items()}
    var = {k: _weights(jax.eval_shape(lambda m=m: m.init(key, xj, False)), i)
           for i, (k, m) in enumerate(mods.items())}

    def run(var, xj):
        out = {}
        for k, m in mods.items():
            ev = m.apply(var[k], xj, False)
            if "batch_stats" in var[k]:
                tr, upd = m.apply(var[k], xj, True, mutable=["batch_stats"])
            else:
                tr, upd = ev, {}
            out[k] = dict(eval=ev, train=tr, stats=upd)
        return out

    res = jax.device_get(jax.jit(run)(var, xj))
    return dict(res=res, var=var, x=x)


def _port(name, ref):
    _, cls, kw = NETS[name]
    tm = cls(**kw)
    tm.load_state_dict(image_backbone_flax_to_state_dict(ref["var"][name], tm), strict=True)
    assert sum(p.numel() for p in tm.parameters()) == sum(
        int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(ref["var"][name]["params"]))
    return tm


def _nchw(y):
    return np.asarray(y).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("name", list(NETS))
@pytest.mark.parametrize("train", [False, True])
def test_image_backbone_against_jax(ref, name, train):
    tm = _port(name, ref).train(train)
    with torch.no_grad():
        got = tm(t(ref["x"]))
    want = ref["res"][name]["train" if train else "eval"]
    assert len(got) == len(want) == (2 if name == "ssdvgg" else 4)
    for g, w in zip(got, want):
        assert tuple(g.shape) == _nchw(w).shape
        assert _rel(g, _nchw(w)) <= TOL
    if train and name != "ssdvgg":
        # the updated running statistics: back through the converter's names
        new = copy.deepcopy(ref["var"][name])
        new["batch_stats"] = ref["res"][name]["stats"]["batch_stats"]
        sd = image_backbone_flax_to_state_dict(new, tm)
        moved = 0
        for k, v in tm.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                assert _rel(v, sd[k]) <= TOL, k
                moved += not torch.equal(sd[k], _port(name, ref).state_dict()[k])
        assert moved > 0


def test_mean_vfe_against_jax():
    rng = np.random.RandomState(1)
    voxels = rng.normal(0, 3, (2, 50, 10, 5)).astype(np.float32)
    num = rng.randint(0, 11, (2, 50)).astype(np.int32)
    num[0, :3] = 0  # empty voxels: divided by 1
    want = np.asarray(JVFE().apply({}, jnp.asarray(voxels), jnp.asarray(num)))
    got = VoxelFeatureExtractorV3()(t(voxels), t(num))
    assert got.shape == (2, 50, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert (got[0, :3] == 0).all()
