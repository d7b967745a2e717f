"""Port parity: the banded gather-GEMM (dal3d_tpu_torch/ops/banded.py) against
dal3d_tpu/ops/banded.py.

The port's plain version is held against JAX's XLA twin and the Pallas
kernel in interpret mode on the same in-band rulebook (f32, atol 1e-4:
summation order only). The port's full-rulebook op is held against JAX's
band plan + fallback where the fallback covers every out-of-band entry."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dal3d_tpu.ops import banded as bd
from dal3d_tpu_torch.ops import banded as tbd
from torch_port_utils import mk_rulebook, t


def _jax_plan(case):
    rng = np.random.RandomState(case["seed"])
    B, Q, M, Mb = 2, case["Q"], case["M"], case["M"]
    idx, hit = mk_rulebook(rng, B, Q, M, Mb, spread=case["spread"])
    if case.get("self_tap") is not None:  # tap = identity, always hit
        idx[:, case["self_tap"]] = np.arange(M, dtype=np.int32)
        hit[:, case["self_tap"]] = True
    table = rng.randn(B, Mb, 128).astype(np.float32)
    wband = (rng.randn(Q, 128, 128) * 0.1).astype(np.float32)
    plan = bd.make_band_plan(jnp.asarray(idx), jnp.asarray(hit), Mb, band=case["band"],
                             fb_cap=case["fb_cap"], self_tap=case.get("self_tap"))
    return idx, hit, table, wband, plan


# cases of test_banded.py::test_pallas_kernel_{interpret,self_tap}_matches_xla
CASES = {
    "generic": dict(seed=8, Q=3, M=256, spread=40, band=128, fb_cap=512),
    "self_tap": dict(seed=9, Q=3, M=512, spread=60, band=160, fb_cap=1024, self_tap=1),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_kernel(name):
    case = CASES[name]
    _, _, table, wband, plan = _jax_plan(case)
    got = tbd.banded_conv_plain(t(table), t(plan.idx_k), t(wband)).numpy()
    ref_xla = np.asarray(bd._banded_fwd_xla(jnp.asarray(table), plan.idx_k, jnp.asarray(wband)))
    os.environ["DAL3D_BANDED"] = "interpret"
    try:
        ref_pallas = np.asarray(bd._banded_fwd_pallas(
            jnp.asarray(table), plan.idx_k, plan.starts, jnp.asarray(wband),
            plan.groups, plan.bands, plan.bm, self_tap=plan.self_tap))
    finally:
        del os.environ["DAL3D_BANDED"]
    np.testing.assert_allclose(got, ref_xla, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, ref_pallas, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("band", [128, 256])
def test_full_rulebook_matches_band_plan_and_fallback(band):
    """No band plan in the port: where(hit, idx, -1) through one op equals
    JAX's in-band kernel + exact fallback (which must cover every entry)."""
    case = dict(seed=0, Q=5, M=384, spread=120, band=band, fb_cap=2048)
    idx, hit, table, wband, plan = _jax_plan(case)
    assert int(plan.oob_count.sum()) > 0  # the fallback really carries entries
    np.testing.assert_array_equal(np.asarray(plan.fb_covered), np.asarray(plan.oob_count))
    ref = np.asarray(bd.banded_gather_matmul(jnp.asarray(table), jnp.asarray(wband), plan))
    got = tbd.banded_gather_matmul(t(table), t(wband), t(np.where(hit, idx, -1))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_bf16_rounds_once():
    """bf16 in, f32 accumulate, one rounding: the port matches JAX's XLA twin
    on an in-band rulebook to one bf16 ulp (at most 2**-7 of the value) —
    the only difference is the f32 summation order before the rounding."""
    _, _, table, wband, plan = _jax_plan(CASES["generic"])
    tb = jnp.asarray(table, jnp.bfloat16)
    wb = jnp.asarray(wband, jnp.bfloat16)
    ref = np.asarray(bd._banded_fwd_xla(tb, plan.idx_k, wb).astype(jnp.float32))
    got = tbd.banded_conv_plain(t(table, torch.bfloat16), t(plan.idx_k),
                                t(wband, torch.bfloat16)).float().numpy()
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -7, atol=1e-6)


def test_any_width_matches_loop_reference():
    """Widths the kernel would pad (R 90, Rout 306) and M != Mb: the op
    equals a per-tap numpy loop over the same rulebook."""
    rng = np.random.RandomState(3)
    B, Q, M, Mb, R, Rout = 2, 3, 96, 80, 90, 306
    idx, hit = mk_rulebook(rng, B, Q, M, Mb, spread=10)
    table = rng.randn(B, Mb, R).astype(np.float32)
    wband = rng.randn(Q, R, Rout).astype(np.float32)
    got = tbd.banded_gather_matmul(t(table), t(wband), t(np.where(hit, idx, -1).astype(np.int64)))
    assert got.shape == (B, M, Rout)
    ref = np.zeros((B, M, Rout), np.float32)
    for b in range(B):
        for q in range(Q):
            ref[b] += np.where(hit[b, q][:, None], table[b][idx[b, q]], 0.0) @ wband[q]
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)

