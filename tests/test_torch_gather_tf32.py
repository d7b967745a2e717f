"""CPU tests of the design of the redesigned fused gather-GEMM kernel (K4,
dal3d_tpu_torch/ops/csrc/gather.cu) and row gather (K5), where the CUDA
kernels cannot run.

- 3xTF32: a plain emulation of the kernel's arithmetic (operands split into
  big = tf32(x) and small = tf32(x - big), rounded to nearest with ties away
  from zero by integer operations on the f32 bits; small*big + big*small +
  big*big into f32 sums) stays within the card tests' 1e-5 of scale of
  gather_gemm_plain at the path's widths, and single-pass TF32 does not:
  the reason for the three passes.
- The plan (ops/gather.py::gather_plan): a permutation, the same on a second
  call, and it cuts the (row, tap) pairs the kernel multiplies against an
  unsorted walk (rows in rulebook order, each tap with a hit in a tile over
  all of its rows): by at least 3x on an L0-like rulebook (surface
  voxels in random order, a capped share of them kept, about 10 % hits) and
  by at least 1.5x over the tiny BEVFusion predict's 21 launches.
- The walk: a plain replay of the kernel's tiles (row groups that skip the
  taps none of their rows hits, each output row written once at its place),
  on a sorted plan and on one that keeps the rows' order, equals
  gather_gemm_plain; the row gather on the strided [B, H*W, C] view of
  an NCHW map is bit-equal to table[idx] on a contiguous copy.
- The weight-gradient kernel (K4-dW, TF32 wgmma): a model of its sum (the
  tensor cores' accumulator truncating after every k8 product, fresh for
  each 32-position chunk, chunks added to f32 sums to nearest) stays within
  1e-5 of scale over one tap hit by 20480 positions, where one truncating
  accumulator over the whole reduction drifts past it; the layout its
  split pass writes (row r, positions 4q..4q+3 at byte r * 128 + (q ^ (r %
  8)) * 16) is the 128-byte swizzle the wgmma descriptor reads, and each
  8-lane phase of its 16-byte stores covers 8 distinct bank groups; the
  chunk shares of every launch of the path cover the plan as the C entry
  checks.
"""
import numpy as np
import pytest
import torch

from dal3d_tpu_torch.ops import gather as tg
from dal3d_tpu_torch.ops import sparse_grid as spg
from dal3d_tpu_torch.ops.sparse import SparseBatch
from torch_port_utils import t

K4_TOL = 1e-5  # of the output's scale, as on the card


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as PTX cvt.rna.tf32.f32: add half of the dropped 13 bits to the
    magnitude bits, then clear them."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def emulated_gather_gemm(feats, idx, hit, w, passes: int) -> np.ndarray:
    """The kernel's sum in numpy: per tap and 8-wide Cin step, the TF32
    products (exact in f32) of 3 passes (small*big, big*small, big*big) or
    1 (big*big) added to f32 accumulators."""
    B, N, Cin = feats.shape
    K, M = idx.shape[1], idx.shape[2]
    cinp = -(-Cin // 8) * 8
    f = np.zeros((B, N, cinp), np.float32)
    f[..., :Cin] = feats
    ww = np.zeros((K, cinp, w.shape[-1]), np.float32)
    ww[:, :Cin] = w
    fb, wb = tf32_rna(f), tf32_rna(ww)
    fs, ws = tf32_rna(f - fb), tf32_rna(ww - wb)
    out = np.zeros((B, M, w.shape[-1]), np.float32)
    for b in range(B):
        for k in range(K):
            rows = np.where(hit[b, k], idx[b, k], -1)
            keep = (rows >= 0)[:, None]
            ab, as_ = np.where(keep, fb[b, rows], 0.0), np.where(keep, fs[b, rows], 0.0)
            for c in range(0, cinp, 8):
                s = slice(c, c + 8)
                part = ab[:, s].astype(np.float64) @ wb[k, s]
                if passes == 3:
                    part += as_[:, s].astype(np.float64) @ wb[k, s] + ab[:, s] @ ws[k, s].astype(
                        np.float64)
                out[b] = (out[b] + part).astype(np.float32)
    return out


def test_tf32_rounding_is_nearest_ties_away():
    x = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                  1.0 + 2.0 ** -12, 3.0e38], np.float32)
    got = tf32_rna(x)
    np.testing.assert_array_equal(got[:5], np.array(
        [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -(1.0 + 2.0 ** -10), 1.0], np.float32))
    assert abs(float(got[5]) / 3.0e38 - 1.0) < 2.0 ** -11
    r = np.random.RandomState(0).randn(10000).astype(np.float32)
    big = tf32_rna(r)
    assert np.all(big.view(np.uint32) & np.uint32(0x1FFF) == 0)
    assert np.all(np.abs(r - big) <= np.abs(r) * 2.0 ** -11)


@pytest.mark.parametrize("Cin,Cout", [(5, 16), (16, 16), (64, 64), (128, 128)])
def test_3xtf32_within_tolerance_single_pass_not(Cin, Cout):
    rng = np.random.RandomState(Cin + Cout)
    B, N, K, M = 1, 300, 27, 160
    feats = (rng.randn(B, N, Cin) * 10.0 ** rng.uniform(-1, 1, (B, N, Cin))).astype(np.float32)
    idx = rng.randint(0, N, (B, K, M)).astype(np.int32)
    hit = rng.rand(B, K, M) < 0.4
    w = (rng.randn(K, Cin, Cout) * 0.1).astype(np.float32)
    ref = tg.gather_gemm_plain(t(feats), t(idx), t(hit), t(w)).double().numpy()
    scale = float(np.abs(ref).max())
    err3 = float(np.abs(emulated_gather_gemm(feats, idx, hit, w, 3) - ref).max()) / scale
    err1 = float(np.abs(emulated_gather_gemm(feats, idx, hit, w, 1) - ref).max()) / scale
    assert err3 <= K4_TOL, err3
    assert err1 > K4_TOL, err1


def surface_rulebook(seed, n_keep=6000, shape=(41, 160, 160)):
    """An L0-like subm rulebook: the voxels of a ground plane with steps and
    a few walls, in random order, the first n_keep kept (a capped
    voxelizer on shuffled points)."""
    rng = np.random.RandomState(seed)
    D, H, W = shape
    y, x = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    z = 8 + x // 40 + (rng.rand(H, W) < 0.2)
    pts = [np.stack([z.ravel(), y.ravel(), x.ravel()], 1)]
    for _ in range(12):
        y0, x0, n = rng.randint(0, H), rng.randint(0, W - 40), rng.randint(10, 40)
        zz, xx = np.meshgrid(np.arange(10, 20), np.arange(x0, x0 + n), indexing="ij")
        pts.append(np.stack([zz.ravel(), np.full(zz.size, y0), xx.ravel()], 1))
    c = np.unique(np.concatenate(pts).astype(np.int64), axis=0)
    c = c[rng.permutation(len(c))][:n_keep]
    lin = torch.from_numpy(((c[:, 0] * H + c[:, 1]) * W + c[:, 2]).astype(np.int32))[None]
    return spg.subm_rulebook(SparseBatch(features=torch.zeros(1, n_keep, 1), lin=lin,
                                         shape=shape), 3)


def unsorted_walk(hit, cout: int) -> int:
    """(row, tap) pairs of an unsorted walk: rows in rulebook order, tiles
    of 256 / 128 / 64 rows by Cout (the FMA version of the kernel, before
    3xTF32), each tap with a hit in the tile over all its rows."""
    c = tg._cout_pad(cout)
    bm = 256 if c == 16 else (128 if c <= 64 else 64)
    B, K, M = hit.shape
    T = -(-M // bm)
    h = torch.nn.functional.pad(hit, (0, T * bm - M))
    return int(h.view(B, K, T, bm).any(-1).sum()) * bm


def walked(plan, cout: int) -> int:
    return int(tg.gemm_walk(plan, cout)[1].sum()) * tg.gemm_tile_rows(cout)[1]


def check_plan(idx, hit):
    plan = tg.gather_plan(idx, hit)
    B, K, M = idx.shape
    assert plan.rulebook.dtype == torch.int32 and plan.order.dtype == torch.int64
    for b in range(B):
        assert torch.equal(torch.sort(plan.order[b].long())[0], torch.arange(M))
    again = tg.gather_plan(idx, hit)
    assert torch.equal(plan.order, again.order) and torch.equal(plan.rulebook, again.rulebook)
    o = plan.order.long()[:, None, :].expand(B, K, M)
    assert torch.equal(plan.rulebook, torch.where(hit, idx, -1).gather(2, o))
    return plan


@pytest.mark.parametrize("seed", [0, 1])
def test_plan_cuts_the_walk_of_an_l0_like_rulebook(seed):
    idx, hit = surface_rulebook(seed)
    assert 0.05 < float(hit.float().mean()) < 0.2
    plan = check_plan(idx, hit)
    hits = int(hit.sum())
    for cout in (16, 32, 64, 128):
        new, old = walked(plan, cout), unsorted_walk(hit, cout)
        assert new <= 3 * hits and old >= 3 * new, (cout, new / hits, old / hits)


def tiny_bevfusion_calls():
    from dal3d_tpu_torch.core.voxel_generator import points_to_voxel_mean as voxelize
    from dal3d_tpu_torch.models.builder import build_bevfusion
    from dal3d_tpu_torch.runtime.bevfusion_steps import make_bevfusion_predict_step

    # the tiny lidar-only model of tests/test_torch_bevfusion.py, a (41, 64, 64) grid
    vg = dict(range=[-6.4, -6.4, -5.0, 6.4, 6.4, 3.0], voxel_size=[0.2, 0.2, 0.2],
              max_points_in_voxel=10, max_voxel_num=1800)
    cfg = {"model": dict(type="BEVFusion", with_camera=False, num_proposals=8,
                         decoder_channels=(16, 32), decoder_layer_nums=(1, 1),
                         neck_out_channels=(16, 16), hidden_channel=16, ffn_channel=32,
                         num_heads=2, voxel_caps=(2000, 1000, 500, 500)),
           "voxel_generator": vg,
           "test_cfg": dict(out_size_factor=8, voxel_size=[0.2, 0.2], pc_range=[-6.4, -6.4])}
    rng = np.random.RandomState(3)
    cap = vg["max_voxel_num"]
    vf, vc, vv = (np.zeros((2, cap, 5), np.float32), np.zeros((2, cap, 3), np.int32),
                  np.zeros((2, cap), bool))
    for b in range(2):
        pts = rng.uniform([-6.4, -6.4, -3.0, 0, 0], [6.4, 6.4, 1.0, 255, 0],
                          (6000, 5)).astype(np.float32)
        f, c, _ = voxelize(pts, vg["voxel_size"], vg["range"], vg["max_points_in_voxel"], cap)
        vf[b, :len(f)], vc[b, :len(f)], vv[b, :len(f)] = f, c, True
    calls, orig = [], tg.gather_gemm

    def spy(f, idx, hit, w, plan=None):
        calls.append((f, idx, hit, w, plan))
        return orig(f, idx, hit, w, plan)

    tg.gather_gemm = spy
    try:
        make_bevfusion_predict_step(build_bevfusion(cfg, device="cpu", seed=1))(
            {"voxel_features": vf, "voxel_coords": vc, "voxel_valid": vv})
    finally:
        tg.gather_gemm = orig
    return calls


def test_plan_cuts_the_walk_of_the_tiny_bevfusion_predict():
    calls = tiny_bevfusion_calls()
    assert len(calls) == 21
    # the stem and the L0 subm convs share one sorted plan, each later level's
    # subm convs theirs; the four strided convs' rulebooks, used once, keep
    # their rows' order (the wrapper's plan)
    assert sum(c[4] is not None for c in calls) == 17 and calls[0][4] is calls[4][4]
    new = old = 0
    for f, idx, hit, w, plan in calls:
        p = check_plan(idx, hit)
        if plan is not None:
            assert torch.equal(plan.order, p.order) and torch.equal(plan.rulebook, p.rulebook)
        else:
            p = tg.gather_plan(idx, hit, sort=False)
        new += walked(p, w.shape[-1])
        old += unsorted_walk(hit, w.shape[-1])
    assert old >= 1.5 * new, old / new


def replay_walk(features, plan, weights):
    """The kernel's walk in plain PyTorch: for each row group of each
    block, the taps its rows hit in tap order (f32 products), the
    sum written once at the rows' places."""
    B, K, M = plan.rulebook.shape
    Cout = weights.shape[-1]
    wr = tg.gemm_tile_rows(Cout)[1]
    _, groups = tg.gemm_walk(plan, Cout)
    out = torch.full((B, M, Cout), float("nan"))
    written = torch.zeros(B, M, dtype=torch.int64)
    for b in range(B):
        for g in range(groups.shape[1]):
            if g * wr >= M:
                break
            pos = torch.arange(g * wr, min((g + 1) * wr, M))
            acc = torch.zeros(len(pos), Cout)
            for k in range(K):
                r = plan.rulebook[b, k, pos].long()
                if not groups[b, g, k]:
                    assert bool((r < 0).all())  # a skipped tap has no hit in the group
                    continue
                a = torch.where((r >= 0)[:, None], features[b, r.clamp(min=0)], 0.0)
                acc += a @ weights[k]
            rows = pos if plan.order is None else plan.order[b, pos]
            out[b, rows] = acc
            written[b, rows] += 1
    assert bool((written == 1).all())
    return out


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("Cin,Cout,M", [(5, 16, 300), (16, 32, 257), (32, 64, 200), (64, 128, 129),
                                         (12, 200, 77)])
def test_replayed_walk_equals_plain(Cin, Cout, M, sort):
    rng = np.random.RandomState(Cin * Cout + M)
    B, N, K = 2, 150, 27
    feats = t(rng.randn(B, N, Cin).astype(np.float32))
    idx = t(rng.randint(0, N, (B, K, M)).astype(np.int32))
    hit = t(rng.rand(B, K, M) < 0.2)
    hit[:, :, 40:90] = False  # rows without a hit: a block or group with no taps
    w = t((rng.randn(K, Cin, Cout) * 0.1).astype(np.float32))
    got = replay_walk(feats, tg.gather_plan(idx, hit, sort=sort), w)
    ref = tg.gather_gemm_plain(feats, idx, hit, w)
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
    assert float(got[:, 40:90].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_gather_reads_the_strided_view(dtype):
    """TransFusion's query gather: the [B, H*W, C] view of an NCHW map,
    rows in (batch, pixel) order, without the map's copy."""
    rng = np.random.RandomState(2)
    x = t(rng.randn(2, 24, 6, 7).astype(np.float32)).to(dtype)
    view = x.permute(0, 2, 3, 1).reshape(2, 42, 24)
    assert view.data_ptr() == x.data_ptr() and not view.is_contiguous()
    rows = t(rng.randint(0, 84, 30).astype(np.int32))
    ref = view.contiguous().view(84, 24)[rows.long()]
    assert torch.equal(tg.gather_rows_plain(view, rows), ref)
    assert torch.equal(tg.gather_rows(view, rows), ref)
    assert torch.equal(tg.gather_rows(view[0], rows[rows < 42]), view[0][rows[rows < 42].long()])


def _trunc32(x: np.ndarray) -> np.ndarray:
    """f64 -> f32 rounded toward zero (the tensor cores' accumulator)."""
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def emulated_dw(f: np.ndarray, g: np.ndarray, fresh_per_chunk: bool) -> np.ndarray:
    """One tap's f^T g [Cin, Cout] over positions as K4-dW sums it: per
    32-position chunk small*big, big*small, big*big, each over four k8
    steps, every product added to an accumulator that truncates; the
    accumulator fresh per chunk and added to f32 sums to nearest, or one
    accumulator over the whole reduction."""
    fb, gb = tf32_rna(f), tf32_rna(g)
    fs, gs = tf32_rna(f - fb), tf32_rna(g - gb)
    sums = np.zeros((f.shape[1], g.shape[1]), np.float32)
    acc = np.zeros_like(sums)
    for c0 in range(0, f.shape[0], tg.DW_CHUNK):
        if fresh_per_chunk:
            acc = np.zeros_like(sums)
        for a, b in ((fs, gb), (fb, gs), (fb, gb)):
            for k in range(c0, c0 + tg.DW_CHUNK, 8):
                acc = _trunc32(acc.astype(np.float64) + a[k:k + 8].T.astype(np.float64) @ b[k:k + 8])
        if fresh_per_chunk:
            sums = (sums + acc).astype(np.float32)
    return sums if fresh_per_chunk else acc


def test_dw_chunked_sums_hold_a_long_reduction():
    rng = np.random.RandomState(0)
    P = 20480
    f = rng.rand(P, 16).astype(np.float32)
    g = rng.rand(P, 16).astype(np.float32)
    ref = f.T.astype(np.float64) @ g
    scale = float(np.abs(ref).max())
    chunked = float(np.abs(emulated_dw(f, g, True) - ref).max()) / scale
    one_chain = float(np.abs(emulated_dw(f, g, False) - ref).max()) / scale
    assert chunked <= K4_TOL / 5, chunked
    assert one_chain > K4_TOL, one_chain


@pytest.mark.parametrize("rows", [8, 16, 32, 64, 128])
def test_dw_split_layout_is_the_wgmma_swizzle(rows):
    """The split pass's store offset of (row, positions 4q..4q+3) against
    the 128-byte swizzle on byte addresses (bits 4-6 XOR bits 7-9) that the
    wgmma descriptor reads, for every element of a [rows][32] plane; and
    its 16-byte stores by 8 consecutive rows at one q hit 8 distinct
    16-byte bank groups."""
    r = np.arange(rows)[:, None]
    pos = np.arange(32)[None, :]
    written = r * 128 + ((pos // 4) ^ (r & 7)) * 16 + (pos % 4) * 4
    linear = r * 128 + pos * 4
    read = linear ^ (((linear >> 7) & 7) << 4)
    np.testing.assert_array_equal(written, read)
    assert len(np.unique(written)) == rows * 32
    for r0 in range(0, rows, 8):
        for q in range(8):
            groups = {((rr * 128 + ((q ^ (rr & 7)) * 16)) % 128) // 16 for rr in range(r0, r0 + 8)}
            assert len(groups) == 8


# (Cin, Cout, M) of the BEVFusion encoder's launches (the stem's Cin 5
# padded to 8), a width of no tile, a plan of one chunk, and Cout 200
DW_LAUNCHES = [(8, 16, 120000), (16, 16, 120000), (16, 32, 60000), (32, 32, 60000),
               (32, 64, 30000), (64, 64, 30000), (64, 128, 30000), (128, 128, 30000),
               (12, 20, 2500), (64, 128, 32), (128, 200, 70000)]


@pytest.mark.parametrize(
    "Cin,Cout,M,bf16", [(*c, False) for c in DW_LAUNCHES] + [(*c, True) for c in DW_LAUNCHES],
    ids=[f"{a}-{b}-{c}" for a, b, c in DW_LAUNCHES] + [f"bf16-{a}-{b}-{c}" for a, b, c in DW_LAUNCHES])
def test_dw_chunk_shares_cover_the_plan(Cin, Cout, M, bf16):
    """The shares a dW launch gets satisfy the C entry's check (every chunk
    in exactly one share, runs of at most DW_MAX_CHUNKS) and come near
    the waves of blocks the tile's occupancy asks for, for the f32 kernel
    (32-position chunks) and the bf16 one (64)."""
    chunk = tg.DW_BF16_CHUNK if bf16 else tg.DW_CHUNK
    per_sm = tg._dw_bf16_blocks_per_sm if bf16 else tg._dw_blocks_per_sm
    for B, K in ((2, 27), (2, 3), (1, 1)):
        chunks = B * -(-M // chunk)
        shares, cps = tg._dw_chunk_shares(B, M, K, Cin, Cout, bf16)
        assert 0 < cps <= tg.DW_MAX_CHUNKS
        assert shares * cps >= chunks and (shares - 1) * cps < chunks
        ti, to = tg._dw_tiles(Cin, Cout)
        assert ti >= min(Cin, 64) and to >= min(Cout, 128)
        per_share = K * -(-Cin // ti) * -(-Cout // to)
        assert 1 <= per_sm(ti, to) <= 4 or not bf16
        want = (tg._DW_BF16_WAVES if bf16 else tg._DW_WAVES) * tg._SMS * per_sm(ti, to)
        if cps < tg.DW_MAX_CHUNKS:
            assert shares * per_share <= want + per_share
        assert 2 * shares * per_share >= min(want, chunks * per_share)
