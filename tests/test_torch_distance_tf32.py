"""CPU tests of the design of the 3xTF32 pairwise L2 kernel (K7,
dal3d_tpu_torch/ops/csrc/pairwise_l2_tf32.cu), where the CUDA kernel cannot
run.

- The sum: a numpy emulation of the kernel's arithmetic. The pre-pass splits
  each value into big = tf32(v) and small = tf32(v - big) (round to nearest,
  ties away from zero) with C zero-padded to the 32-float k tile; per chunk
  of k the wgmma chain takes small*big, big*small, then big*big, 8 columns an
  instruction, into a fresh accumulator whose f32 sum is modelled as
  truncating (the tensor cores' sum rounds toward zero); each chunk is then
  added to the f32 sums with round-to-nearest adds. Held to chip_smoke.py's
  tolerances against pairwise_l2_plain on embeddings shaped like the
  selection's (non-negative, clustered by scene) at C = 512 and on awkward
  widths: squared distances within 2e-6 of |x|^2 + |y|^2, distances within
  1e-4 relative where d > 0.1 sqrt(scale). Single-pass TF32 misses them.
- The chunk: one k tile of 32 (twelve instructions a chunk) has the error
  of chunks of 8, while one chain over all of C drifts toward zero.
- The pre-pass: a plain replay of its padding and split.
"""
import numpy as np
import pytest
import torch

from dal3d_tpu_torch.ops import distance as td

K_TILE = td._K_TILE  # the kernel's k step and chunk
D2_TOL, REL_TOL = 2e-6, 1e-4


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as the pre-pass's integer split and cvt.rna.tf32.f32 give it."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def trunc_f32(x: np.ndarray) -> np.ndarray:
    """f64 -> f32 rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def split(x: np.ndarray, cp: int):
    """The pre-pass: norms, and the big / small planes padded to cp."""
    xp = np.zeros((x.shape[0], cp), np.float32)
    xp[:, :x.shape[1]] = x
    big = tf32_rna(xp)
    return (x * x).sum(1, dtype=np.float32), big, tf32_rna(xp - big)


def emulated_l2_squared(x, y, chunk=K_TILE, passes=3):
    """The kernel's squared distances in numpy (chunk: columns of k summed
    into one fresh accumulator)."""
    cp = -(-x.shape[1] // K_TILE) * K_TILE
    xn, xb, xs = split(x, cp)
    yn, yb, ys = split(y, cp)
    pairs = [(xs, yb), (xb, ys), (xb, yb)] if passes == 3 else [(xb, yb)]
    sums = np.zeros((x.shape[0], y.shape[0]), np.float32)
    for c0 in range(0, cp, chunk):
        part = np.zeros_like(sums)
        for a, b in pairs:
            for k in range(c0, c0 + chunk, 8):
                s = a[:, k:k + 8].astype(np.float64) @ b[:, k:k + 8].T.astype(np.float64)
                part = trunc_f32(part + s)
        sums = sums + part
    return np.maximum(xn[:, None] + yn[None, :] - np.float32(2.0) * sums, 0.0)


def embeddings(rng, n: int, scenes: int, C: int = 512) -> np.ndarray:
    """As chip_smoke.py::embeddings: non-negative, frames of one scene close."""
    centers = rng.randn(scenes, C).astype(np.float32)
    scene = np.sort(rng.randint(0, scenes, n))
    return np.maximum(centers[scene] + 0.35 * rng.randn(n, C).astype(np.float32), 0.0)


def errors(x, y, got2):
    """(max squared-distance error / scale, max relative distance error away
    from the diagonal, mean signed squared error / scale)."""
    ref2 = td.pairwise_l2_plain(torch.from_numpy(x), torch.from_numpy(y), squared=True).numpy()
    scale = (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
    d, dr = np.sqrt(got2), np.sqrt(ref2)
    far = dr > 0.1 * np.sqrt(scale)
    rel = float((np.abs(d - dr) / np.maximum(dr, 1e-30))[far].max()) if far.any() else 0.0
    return float((np.abs(got2 - ref2) / scale).max()), rel, float(((got2 - ref2) / scale).mean())


def inputs(C: int, seed: int):
    rng = np.random.RandomState(seed)
    if C == 512:
        p = embeddings(rng, 1200, 40)
        return p[rng.permutation(1200)[:96]], p
    return np.abs(rng.randn(96, C)).astype(np.float32), np.abs(rng.randn(700, C)).astype(np.float32)


@pytest.mark.parametrize("C", [512, 16, 500])
def test_3xtf32_within_tolerance_single_pass_not(C):
    x, y = inputs(C, C)
    d2, rel, _ = errors(x, y, emulated_l2_squared(x, y))
    assert d2 <= D2_TOL and rel <= REL_TOL, (d2, rel)
    d2_1, rel_1, _ = errors(x, y, emulated_l2_squared(x, y, passes=1))
    assert d2_1 > D2_TOL or rel_1 > REL_TOL, (d2_1, rel_1)  # outside either tolerance


def test_chunk_of_one_k_tile():
    """Fresh accumulators per 32 columns: no worse than per 8 (the fused
    gather-GEMM's step), while one truncating chain over all 512 columns
    drifts toward zero at many times the bias."""
    x, y = inputs(512, 1)
    e32, _, bias32 = errors(x, y, emulated_l2_squared(x, y, chunk=32))
    e8, _, _ = errors(x, y, emulated_l2_squared(x, y, chunk=8))
    eall, _, bias_all = errors(x, y, emulated_l2_squared(x, y, chunk=512))
    assert e32 <= D2_TOL and e32 <= 1.25 * e8, (e32, e8)
    assert bias_all > 5 * abs(bias32) and eall > e32, (bias_all, bias32, eall, e32)


@pytest.mark.parametrize("C", [16, 500, 512])
def test_prepass_replay(C):
    """Padding to the k tile adds exact zeros: the split parts sum back to
    the input within 2^-22 of it, the padded columns are 0 in both planes,
    and the Gram form on the padded inputs is the plain one."""
    x, y = inputs(C, 7)
    cp = -(-C // K_TILE) * K_TILE
    assert cp % K_TILE == 0 and cp - C < K_TILE
    xn, xb, xs = split(x, cp)
    assert np.all(xb[:, C:] == 0) and np.all(xs[:, C:] == 0)
    assert np.all(xb.view(np.uint32) & np.uint32(0x1FFF) == 0)
    assert np.all(xs.view(np.uint32) & np.uint32(0x1FFF) == 0)
    back = xb[:, :C].astype(np.float64) + xs[:, :C]
    assert np.all(np.abs(back - x) <= np.abs(x) * 2.0 ** -22)
    pad = lambda a: torch.from_numpy(np.pad(a, ((0, 0), (0, cp - C))))  # noqa: E731
    ref = td.pairwise_l2_plain(torch.from_numpy(x), torch.from_numpy(y), squared=True)
    got = td.pairwise_l2_plain(pad(x), pad(y), squared=True)
    scale = torch.from_numpy((x * x).sum(1)[:, None] + (y * y).sum(1)[None, :])
    assert float(((got - ref).abs() / scale).max()) <= 1e-6
    np.testing.assert_array_equal(xn, (x * x).sum(1, dtype=np.float32))
