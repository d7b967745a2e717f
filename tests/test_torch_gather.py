"""Port parity of the gather engine's kernels' plain versions
(dal3d_tpu_torch/ops/gather.py) against the JAX package on the CPU.

gather_gemm_plain is held to JAX's ``ops/sparse.py::gather_gemm`` and to the
Pallas kernel ``gather_gemm_pallas`` run in interpret mode, at the sizes of
tests/test_pallas_gather.py (M not tile-aligned, 60 % hits), within 2e-5;
gather_rows_plain is bit-equal to the Pallas ``gather_rows``. The wrappers'
device rules are in tests/test_torch_rules.py; the CUDA kernels themselves
are held to the plain versions on the card (tests/test_torch_kernels_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest

from dal3d_tpu.ops.pallas_gather import gather_gemm_pallas, gather_rows as jax_gather_rows
from dal3d_tpu.ops.sparse import gather_gemm as jax_gather_gemm
from dal3d_tpu_torch.ops import gather as tg
from torch_port_utils import t


def _case(seed, B=2, N=600, Cin=16, K=5, M=1500, Cout=32, hit_p=0.6):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, N, Cin).astype(np.float32)
    idx = rng.randint(0, N, (B, K, M)).astype(np.int32)
    hit = rng.rand(B, K, M) < hit_p
    w = (rng.randn(K, Cin, Cout) * 0.1).astype(np.float32)
    return feats, idx, hit, w


def test_gather_gemm_plain_matches_jax_and_pallas():
    feats, idx, hit, w = _case(1)
    got = tg.gather_gemm_plain(t(feats), t(idx), t(hit), t(w)).numpy()
    ref = np.asarray(jax_gather_gemm(*map(jnp.asarray, (feats, idx, hit, w))))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    pallas = np.asarray(gather_gemm_pallas(*map(jnp.asarray, (feats, idx, hit, w)),
                                           block_m=512, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("Cin,K,M", [(5, 27, 77), (32, 3, 1)])
def test_gather_gemm_plain_awkward_shapes(Cin, K, M):
    """The stem's Cin 5 with 27 taps, and M = 1; a miss adds nothing even
    when its index points at a row."""
    feats, idx, hit, w = _case(2, B=1, N=40, Cin=Cin, K=K, M=M, Cout=16, hit_p=0.5)
    got = tg.gather_gemm_plain(t(feats), t(idx), t(hit), t(w)).numpy()
    ref = np.asarray(jax_gather_gemm(*map(jnp.asarray, (feats, idx, hit, w))))
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    none = tg.gather_gemm_plain(t(feats), t(idx), t(np.zeros_like(hit)), t(w))
    assert float(none.abs().max()) == 0.0


def test_gather_rows_plain_bit_equal_to_pallas():
    rng = np.random.RandomState(0)
    tbl = rng.randn(1000, 16).astype(np.float32)
    idx = rng.randint(0, 1000, 1024).astype(np.int32)
    ref = np.asarray(jax_gather_rows(jnp.asarray(tbl), jnp.asarray(idx), block_m=512,
                                     interpret=True))
    got = tg.gather_rows_plain(t(tbl), t(idx)).numpy()
    np.testing.assert_array_equal(got, ref)
