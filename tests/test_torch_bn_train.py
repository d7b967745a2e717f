"""Port parity: both batch norms in train mode
(dal3d_tpu_torch/models/layers.py) against dal3d_tpu/models/layers.py: outputs
and running statistics after two calls, and the input gradient, f32, 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from dal3d_tpu.models import layers as jl
from dal3d_tpu_torch.models import layers as tl
from torch_port_utils import t


def _load(bn, variables, key=None):
    p, s = variables["params"], variables["batch_stats"]
    if key:
        p, s = p[key], s[key]
    with torch.no_grad():
        bn.weight.copy_(t(p["scale"]))
        bn.bias.copy_(t(p["bias"]))
        bn.running_mean.copy_(t(s["mean"]))
        bn.running_var.copy_(t(s["var"]))


def _variables(rng, C, key=None):
    leaf_p = {"scale": (1 + 0.2 * rng.randn(C)).astype(np.float32),
              "bias": (0.1 * rng.randn(C)).astype(np.float32)}
    leaf_s = {"mean": (0.1 * rng.randn(C)).astype(np.float32),
              "var": (1 + 0.1 * rng.rand(C)).astype(np.float32)}
    if key:
        return {"params": {key: leaf_p}, "batch_stats": {key: leaf_s}}
    return {"params": leaf_p, "batch_stats": leaf_s}


def test_masked_batch_norm_train_matches_jax():
    rng = np.random.RandomState(0)
    C = 16
    xs = [(rng.randn(2, 50, 4, C) * 2 + 0.5).astype(np.float32) for _ in range(2)]
    masks = [rng.rand(2, 50, 4) < 0.6 for _ in range(2)]
    variables = _variables(rng, C)
    mod = jl.MaskedBatchNorm()
    bn = tl.MaskedBatchNorm(C).train()
    _load(bn, variables)
    for x, m in zip(xs, masks):
        ref, upd = mod.apply(variables, jnp.asarray(x), jnp.asarray(m), True, mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
        got = bn(t(x), t(m)).detach()
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        assert float(got[~t(m)].abs().max()) == 0.0
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(variables["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(variables["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)
    # eval mode reads the running statistics and leaves them alone
    before = bn.running_mean.clone()
    ref = mod.apply(variables, jnp.asarray(xs[0]), jnp.asarray(masks[0]), False)
    got = bn.eval()(t(xs[0]), t(masks[0])).detach()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert torch.equal(bn.running_mean, before)


def test_masked_batch_norm_gradient_and_empty_mask():
    rng = np.random.RandomState(1)
    C = 8
    x = rng.randn(2, 30, 4, C).astype(np.float32)
    m = rng.rand(2, 30, 4) < 0.5
    cot = rng.randn(2, 30, 4, C).astype(np.float32)
    variables = _variables(rng, C)
    mod = jl.MaskedBatchNorm()

    def loss(a):
        y, _ = mod.apply(variables, a, jnp.asarray(m), True, mutable=["batch_stats"])
        return jnp.sum(y * jnp.asarray(cot))

    ref = np.asarray(jax.grad(loss)(jnp.asarray(x)))
    bn = tl.MaskedBatchNorm(C).train()
    _load(bn, variables)
    xt = t(x).requires_grad_(True)
    (bn(xt, t(m)) * t(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), ref, rtol=1e-4, atol=1e-5)
    # no valid voxel: the count clamps to 1, statistics 0, output 0
    out = bn(t(x), torch.zeros(2, 30, 4, dtype=torch.bool)).detach()
    assert float(out.abs().max()) == 0.0 and bool(torch.isfinite(bn.running_var).all())


def test_batch_norm_2d_train_matches_flax():
    rng = np.random.RandomState(2)
    C = 12
    xs = [(rng.randn(2, 6, 5, C) * 3 + 1).astype(np.float32) for _ in range(2)]  # NHWC
    variables = _variables(rng, C, key="BatchNorm_0")
    mod = jl.BatchNorm2d()
    bn = tl.BatchNorm2d(C).train()
    _load(bn, variables, key="BatchNorm_0")
    for x in xs:
        ref, upd = mod.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
        got = bn(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach()
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    stats = variables["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-5, atol=1e-6)
    # biased variance in the running average: torch's own module would differ
    ref_torch = torch.nn.BatchNorm2d(C, eps=1e-3, momentum=0.01).train()
    ref_torch(t(xs[0]).permute(0, 3, 1, 2))
    n = 2 * 6 * 5
    biased = t(xs[0]).reshape(-1, C).var(0, unbiased=False)
    assert float((ref_torch.running_var - (0.99 + 0.01 * biased * n / (n - 1))).abs().max()) < 1e-5
