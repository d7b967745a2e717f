"""CPU tests of the design of the bf16 gather kernels on bf16 wgmma
(dal3d_tpu_torch/ops/csrc/gather.cu: gather_gemm_bf16, gather_dw_bf16),
where the CUDA kernels cannot run. Torch and numpy only.

- The walk: ``gemm_walk(..., bf16=True)`` (blocks of one 64-row warpgroup,
  two at Cout 64, each skipping the taps none of its rows hits) counts what a
  brute-force pass over the plan's tiles counts, on seeded plans sorted by
  hit mask and in rulebook order, with M on and off the tiles.
- The shared-memory tiles: the 32-, 64- and 128-byte swizzles the kernels
  write (``swz_off``) put the 8 rows of an atom, at one logical 16-byte
  piece, in 8 distinct 16-byte bank groups, and each row's pieces in
  distinct places.
- The weight gradient's sum: a model of it (each 64-position chunk's four
  k16 products summed in an accumulator that truncates, fresh for each
  chunk, chunks added to f32 sums to nearest) stays within 1e-5 of scale
  over the CBGS L0's longest tap (2 x 60000 positions), where one
  truncating accumulator over the whole reduction drifts past it.
"""
import numpy as np
import pytest
import torch

from dal3d_tpu_torch.ops import gather as tg


def brute_force_walk(rb: np.ndarray, bm: int) -> tuple:
    """(walked rows, block steps): for each block of bm plan positions and
    each 64-row group in it, the taps any of the group's rows hits, 64 rows
    a tap; a block steps through the union of its groups' taps."""
    B, K, M = rb.shape
    rows = steps = 0
    for b in range(B):
        for m0 in range(0, M, bm):
            union = set()
            for g0 in range(m0, m0 + bm, 64):
                taps = {k for k in range(K) if (rb[b, k, g0:min(g0 + 64, M)] >= 0).any()}
                rows += 64 * len(taps)
                union |= taps
            steps += len(union)
    return rows, steps


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("Cout,M", [(16, 300), (32, 257), (64, 1000), (128, 129), (200, 64),
                                    (16, 1)])
def test_bf16_walk_equals_brute_force(Cout, M, sort):
    rng = np.random.RandomState(Cout + M)
    B, K, N = 2, 27, 500
    idx = torch.from_numpy(rng.randint(0, N, (B, K, M)).astype(np.int32))
    hit = torch.from_numpy(rng.rand(B, K, M) < 0.12)
    hit[:, :, M // 3:M // 2] = False
    hit[:, 5] = False
    plan = tg.gather_plan(idx, hit, sort=sort)
    bm, wr = tg.gemm_tile_rows(Cout, bf16=True)
    assert wr == 64 and bm == (128 if Cout == 64 else 64)
    blocks, groups = tg.gemm_walk(plan, Cout, bf16=True)
    rows, steps = brute_force_walk(plan.rulebook.numpy(), bm)
    assert int(groups.sum()) * wr == rows
    assert int(blocks.sum()) == steps
    assert rows >= int(hit.sum())  # every hit walked
    assert tuple(groups.shape) == (B, -(-M // bm) * bm // 64, K)
    # the f32 kernel's finer groups walk no more rows
    f32_rows = int(tg.gemm_walk(plan, Cout)[1].sum()) * tg.gemm_tile_rows(Cout)[1]
    assert int(hit.sum()) <= f32_rows <= rows


def swz_off(rb: int, r: np.ndarray, q: np.ndarray) -> np.ndarray:
    """csrc/common.cuh::swz_off<RB>: bits 4.. of the linear offset XORed
    with bits 7..."""
    lin = r * rb + q * 16
    return lin ^ (((lin >> 7) & (rb // 16 - 1)) << 4)


@pytest.mark.parametrize("rb", [32, 64, 128])
def test_bf16_tile_swizzles_spread_the_bank_groups(rb):
    pieces = rb // 16
    r, q = np.meshgrid(np.arange(64), np.arange(pieces), indexing="ij")
    off = swz_off(rb, r, q)
    assert len(np.unique(off)) == 64 * pieces
    assert (off // rb == r).all()  # a row's pieces stay in the row
    for r0 in range(0, 64, 8):
        for qq in range(pieces):
            banks = {int(swz_off(rb, np.int64(rr), np.int64(qq)) // 16 % 8)
                     for rr in range(r0, r0 + 8)}
            assert len(banks) == 8, (rb, r0, qq)


def _trunc32(x: np.ndarray) -> np.ndarray:
    """f64 -> f32 rounded toward zero (the tensor cores' accumulator)."""
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r




def emulated_bf16_dw(f: np.ndarray, g: np.ndarray, fresh_per_chunk: bool) -> np.ndarray:
    """One tap's f^T g over positions as the bf16 K4-dW sums it: the four
    k16 products (exact in f32) of a chunk of DW_BF16_CHUNK positions each
    added to an accumulator that truncates; fresh per chunk and added to
    f32 sums to nearest, or one accumulator over the whole reduction."""
    sums = np.zeros((f.shape[1], g.shape[1]), np.float32)
    acc = np.zeros_like(sums)
    ch = tg.DW_BF16_CHUNK
    for c0 in range(0, f.shape[0], ch):
        if fresh_per_chunk:
            acc = np.zeros_like(sums)
        for k in range(c0, c0 + ch, 16):
            acc = _trunc32(acc.astype(np.float64) + f[k:k + 16].T.astype(np.float64) @ g[k:k + 16])
        if fresh_per_chunk:
            sums = (sums + acc).astype(np.float32)
    return sums if fresh_per_chunk else acc


def test_bf16_dw_chunked_sums_hold_the_longest_tap():
    rng = np.random.RandomState(0)
    P = 2 * 60000  # the CBGS L0 centre tap at B=2
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16).float().numpy()  # noqa: E731
    f = bf(rng.rand(P, 16).astype(np.float32))
    g = bf(rng.rand(P, 16).astype(np.float32))
    ref = f.T.astype(np.float64) @ g
    scale = float(np.abs(ref).max())
    chunked = float(np.abs(emulated_bf16_dw(f, g, True) - ref).max()) / scale
    one_chain = float(np.abs(emulated_bf16_dw(f, g, False) - ref).max()) / scale
    print(f"chunked {chunked:.2e}, one chain {one_chain:.2e} of scale")
    assert chunked <= 1e-5, chunked
    assert one_chain > 1e-5, one_chain
