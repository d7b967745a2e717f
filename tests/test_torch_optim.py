"""Port parity: OneCycle schedules and the written-out clip + AdamW update
(dal3d_tpu_torch/solver/optim.py) against the JAX package's optax chain
(dal3d_tpu/solver/optim.py) on given gradients: 20 steps across the OneCycle
split, parameters within 1e-6."""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dal3d_tpu.solver import optim as jo
from dal3d_tpu_torch.solver import optim as to
from torch_port_utils import t

SHAPES = {"a/kernel": (3, 4, 5), "a/scale": (5,), "b/kernel": (7, 2), "b/bias": (2,)}


def test_schedules_match_jax():
    cfg = dict(lr_max=0.002, moms=(0.95, 0.85), div_factor=10.0, pct_start=0.4, total_steps=25)
    jc, tc = jo.OneCycleSchedule(**cfg), to.OneCycleSchedule(**cfg)
    steps = list(range(0, 30))
    np.testing.assert_allclose([to.one_cycle_lr(tc)(s) for s in steps],
                               [float(jo.one_cycle_lr(jc)(s)) for s in steps], rtol=2e-6)
    np.testing.assert_allclose([to.one_cycle_momentum(tc)(s) for s in steps],
                               [float(jo.one_cycle_momentum(jc)(s)) for s in steps], rtol=2e-6)
    assert to.one_cycle_lr(tc)(0) == pytest.approx(0.0002) and to.one_cycle_lr(tc)(10) == pytest.approx(0.002)


@pytest.mark.parametrize("grad_scale,clips", [(0.1, False), (30.0, True)])
def test_adamw_with_clip_matches_optax(grad_scale, clips):
    """Given gradients, with and without the clip biting; the split of the
    OneCycle falls at step 8 of 20."""
    rng = np.random.RandomState(0)
    cfg = dict(lr_max=0.002, moms=(0.95, 0.85), div_factor=10.0, pct_start=0.4, total_steps=20)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.randn(*s) * grad_scale).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(20)]
    grads[3]["b/bias"][:] = 0.0  # a zero gradient: the update is the decay alone

    jopt = jo.build_optimizer(jo.OneCycleSchedule(**cfg), weight_decay=0.01, grad_clip_norm=35.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = jopt.init(jp)

    tp = {k: t(v).requires_grad_(True) for k, v in params.items()}
    topt = to.build_optimizer(to.OneCycleSchedule(**cfg), weight_decay=0.01,
                              grad_clip_norm=35.0).init(tp.items())
    bit = 0
    for g in grads:
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        upd, state = jopt.update(jg, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in g.items():
            tp[k].grad = t(v)
        norm = float(topt.step())
        np.testing.assert_allclose(norm, float(optax.global_norm(jg)), rtol=1e-6)
        bit += norm >= 35.0
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=0,
                                       atol=1e-6, err_msg=k)
    assert (bit == 20) == clips and (bit == 0) == (not clips)
    assert topt.count == 20


def test_state_dict_round_trip_continues_the_schedule():
    rng = np.random.RandomState(1)
    cfg = to.OneCycleSchedule(total_steps=10)
    a = {"w": t(rng.randn(4, 3).astype(np.float32)).requires_grad_(True)}
    b = {"w": a["w"].detach().clone().requires_grad_(True)}
    oa = to.build_optimizer(cfg).init(a.items())
    ob = to.build_optimizer(cfg).init(b.items())
    gs = [t(rng.randn(4, 3).astype(np.float32)) for _ in range(6)]
    for g in gs[:3]:
        a["w"].grad = g.clone()
        oa.step()
    saved = oa.state_dict()
    b["w"].data.copy_(a["w"].data)
    ob.load_state_dict(saved)
    assert ob.count == 3
    for g in gs[3:]:
        a["w"].grad, b["w"].grad = g.clone(), g.clone()
        oa.step()
        ob.step()
    assert torch.equal(a["w"], b["w"])
    with pytest.raises(KeyError):
        to.build_optimizer(cfg).init([("other", a["w"])]).load_state_dict(saved)


def test_adam_matches_optax_adam():
    """``solver.optim.Adam`` (the estimator's optimizer) against
    ``optax.adam`` over five steps of random gradients, some zero and some
    missing: the parameters within 1e-7."""
    rng = np.random.RandomState(4)
    shapes = {"a": (5, 3), "b": (7,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tp = {k: torch.nn.Parameter(t(v)) for k, v in params.items()}
    opt = to.Adam(1e-3).init(tp.items())
    ref = optax.adam(1e-3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = ref.init(jp)
    for step in range(5):
        g = {k: (rng.randn(*s) * 10 ** rng.uniform(-4, 1)).astype(np.float32)
             for k, s in shapes.items()}
        g["b"][:2] = 0.0
        if step == 2:
            g["a"][:] = 0.0  # a missing grad counts as zeros
        opt.zero_grad()
        for k in tp:
            if not (step == 2 and k == "a"):
                tp[k].grad = t(g[k])
        opt.step()
        upd, state = ref.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
    for k in tp:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-7)
    assert opt.count == 5
