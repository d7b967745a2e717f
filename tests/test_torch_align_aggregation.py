"""The align-aggregation ops of the PyTorch port
(dal3d_tpu_torch/ops/align_aggregation.py, NCHW) against
dal3d_tpu/ops/align_aggregation.py (NHWC) on the same seeded maps, f32 on
the CPU: ``local_correlation`` and ``align_feature`` within 1e-5 (offsets
row-major over [-r, r]^2, zero outside the map, odd patches 1, 3 and 5),
and ``AlignFeatureAggregation`` within 1e-4 of scale on weights carried
across by ``models/convert_flax.py::align_aggregation_flax_to_state_dict``.
JAX's module runs in one jitted function."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.ops import align_aggregation as ja
from dal3d_tpu_torch.models.convert_flax import align_aggregation_flax_to_state_dict
from dal3d_tpu_torch.ops import align_aggregation as ta
from test_torch_camera_branch import few_threads  # noqa: F401
from torch_port_utils import t

pytestmark = pytest.mark.usefixtures("few_threads")

TOL = 1e-5


def _maps(seed, B=2, C=6, H=9, W=11):
    rng = np.random.RandomState(seed)
    return [rng.normal(0, 1, (B, H, W, C)).astype(np.float32) for _ in range(2)]


def _nchw(x):
    return np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("patch", [1, 3, 5])
def test_local_correlation_and_align_feature_match_jax(patch):
    f1, f2 = _maps(patch)
    want = np.asarray(ja.local_correlation(jnp.asarray(f1), jnp.asarray(f2), patch))
    got = ta.local_correlation(t(_nchw(f1)), t(_nchw(f2)), patch)
    assert got.shape == (2, patch * patch, 9, 11)
    np.testing.assert_allclose(got.numpy(), _nchw(want), rtol=0, atol=TOL)
    w = np.random.RandomState(9).uniform(0, 1, (2, 9, 11, patch * patch)).astype(np.float32)
    want = np.asarray(ja.align_feature(jnp.asarray(f1), jnp.asarray(w), patch))
    got = ta.align_feature(t(_nchw(f1)), t(_nchw(w)), patch)
    np.testing.assert_allclose(got.numpy(), _nchw(want), rtol=0, atol=TOL)


def test_correlation_offsets_are_row_major():
    """Offset o = (dy, dx) reads f2 at (y + dy - r, x + dx - r): a one-hot
    f2 shows which offset sees it, and a border pixel's outside offsets 0."""
    f1 = torch.ones(1, 1, 5, 5)
    f2 = torch.zeros(1, 1, 5, 5)
    f2[0, 0, 1, 3] = 1.0  # one above and one right of the centre (2, 2)
    c = ta.local_correlation(f1, f2, 3)
    assert c[0, :, 2, 2].tolist() == [0, 0, 1, 0, 0, 0, 0, 0, 0]  # o = (dy 0, dx 2)
    assert c[0, :, 0, 0].sum() == 0
    with pytest.raises(ValueError, match="odd"):
        ta.local_correlation(f1, f2, 4)


def test_align_feature_aggregation_matches_jax():
    fs, fc = _maps(11, C=16, H=12, W=10)
    jm = ja.AlignFeatureAggregation(num_channel=16, neighbor=5)
    var = jm.init(jax.random.PRNGKey(3), jnp.asarray(fs), jnp.asarray(fc))
    # biases drawn non-zero, so that every mapped tensor matters
    rng = np.random.RandomState(4)
    var = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.normal(0, 0.1, x.shape).astype(np.float32)
                      if "bias" in jax.tree_util.keystr(p) else np.asarray(x)), var)
    want = np.asarray(jax.jit(jm.apply)(var, jnp.asarray(fs), jnp.asarray(fc)))
    tm = ta.AlignFeatureAggregation(16, neighbor=5)
    tm.load_state_dict(align_aggregation_flax_to_state_dict(var["params"]), strict=True)
    with torch.no_grad():
        got = tm(t(_nchw(fs)), t(_nchw(fc)))
    ref = _nchw(want)
    assert got.shape == ref.shape
    assert float(np.abs(got.numpy() - ref).max() / np.abs(ref).max()) <= 1e-4
