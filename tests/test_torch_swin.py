"""Port parity of the Swin camera backbone (dal3d_tpu_torch/models/bevfusion/
swin.py against dal3d_tpu/models/bevfusion/swin.py) on the CPU.

The flax variables are shaped by ``eval_shape`` (no JAX compile), filled with
seeded numpy values and carried across by the weights bridge
(models/convert_flax.py::swin_flax_to_state_dict). Required: every output
stage within 1e-5 of its scale in eval mode, for a narrow Swin (embed 24,
depths (2, 2, 2, 2), heads (1, 2, 2, 4)) at sizes that are no window
multiple and merge odd maps, and for Swin-T; the narrow Swin's gradients
(parameters and input) within 1e-4 of their scale against ``jax.grad``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.models.bevfusion.swin import SwinTransformer as JaxSwin
from dal3d_tpu_torch.models.bevfusion import swin as tsw
from dal3d_tpu_torch.models.convert_flax import _flatten, swin_flax_to_state_dict
from test_torch_bevfusion import _randomize
from test_torch_camera_branch import few_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_threads")

NARROW = dict(embed_dim=24, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4))
TOL = 1e-5


def _pair(kw, shape, seed):
    """(jax module, its randomised params, the port's module loaded with
    them in eval mode)."""
    jm = JaxSwin(**kw)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros(shape, jnp.float32))
    params = _randomize(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes),
                        np.random.RandomState(seed))["params"]
    tm = tsw.SwinTransformer(**kw)
    sd = swin_flax_to_state_dict(_flatten(params), tm)
    tm.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                       strict=True)
    return jm, params, tm.eval()


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(np.asarray(b)).max(),
                                                                    1e-30))


@pytest.mark.parametrize("hw", [(36, 52), (28, 60)])
def test_narrow_swin_eval_matches_jax(hw):
    """36 x 52: patches 9 x 13 (padded to 14 x 14), odd merges 9 x 13 ->
    5 x 7 -> 3 x 4; 28 x 60: patches 7 x 15, merges 4 x 8 -> 2 x 4 -> 1 x 2."""
    shape = (2, *hw, 3)
    jm, params, tm = _pair(NARROW, shape, 1)
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert _rel(g.numpy(), w) <= TOL


def test_swin_t_eval_matches_jax():
    shape = (2, 32, 48, 3)
    jm, params, tm = _pair({}, shape, 3)
    assert [tuple(v.shape) for v in tm.state_dict().values()][:1] == [(96, 3, 4, 4)]
    x = np.random.RandomState(4).randn(*shape).astype(np.float32)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [(2, 4, 6, 192), (2, 2, 3, 384), (2, 1, 2, 768)]
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= TOL


def test_train_mode_without_drop_path_is_eval_and_drop_path_draws_per_image():
    tm = tsw.SwinTransformer(**NARROW, drop_path_rate=0.0)
    torch.manual_seed(0)
    for p in tm.parameters():
        p.data.normal_(0, 0.1)
    x = torch.randn(2, 36, 52, 3)
    with torch.no_grad():
        ev = tm.eval()(x)
        tr = tm.train()(x)
    assert all(torch.equal(a, b) for a, b in zip(ev, tr))
    # a rate > 0 drops whole images' branches, scaled by 1 / keep, from the
    # module's generator: the same seed draws the same masks
    dp = tsw.DropPath(0.5).train()
    y = torch.ones(64, 3, 5, 1)
    dp.generator = torch.Generator().manual_seed(7)
    a = dp(y)
    dp.generator = torch.Generator().manual_seed(7)
    assert torch.equal(a, dp(y))
    per_image = a.reshape(64, -1)
    assert set(per_image.unique().tolist()) == {0.0, 2.0}
    assert bool((per_image == per_image[:, :1]).all())
    assert 10 < int((per_image[:, 0] == 0).sum()) < 54
    assert torch.equal(dp.eval()(y), y)


def test_shift_mask_and_index_match_jax():
    from dal3d_tpu.models.bevfusion import swin as jsw

    assert np.array_equal(tsw.relative_position_index(7), jsw.relative_position_index(7))
    m = tsw.shift_mask(14, 21, 7, 3)
    assert m.shape == (6, 49, 49) and set(np.unique(m)) == {0.0, -100.0}
    assert not m[0].any()  # the top-left window holds one region


def test_narrow_swin_gradients_match_jax_grad():
    """loss = sum_i <out_i, r_i> for fixed seeded r_i; the parameter
    gradients carried over by the same (linear) bridge, and the input's."""
    shape = (2, 36, 52, 3)
    jm, params, tm = _pair(NARROW, shape, 5)
    rng = np.random.RandomState(6)
    x = rng.randn(*shape).astype(np.float32)
    with torch.no_grad():
        outs = tm(torch.from_numpy(x))
    rs = [rng.randn(*o.shape).astype(np.float32) for o in outs]

    def loss(p, xin):
        ys = jm.apply({"params": p}, xin)
        return sum(jnp.sum(y * r) for y, r in zip(ys, rs))

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    tm.zero_grad()
    ls = sum((y * torch.from_numpy(r)).sum() for y, r in zip(tm(xt), rs))
    ls.backward()
    want = swin_flax_to_state_dict(_flatten(jax.tree_util.tree_map(np.asarray, gp)), tm)
    got = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    assert set(want) == set(got)
    for n in got:
        assert _rel(got[n], want[n]) <= 1e-4, n
    assert _rel(xt.grad.numpy(), gx) <= 1e-4
