"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports torch and the port only (no JAX), so it runs on a GPU machine:
    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest
Every test takes the ``cuda`` fixture and skips on a box without a GPU. The
plain versions are held to the JAX package by the other tests/test_torch_*
files on the CPU; here the kernels are held to the plain versions."""
import numpy as np
import pytest
import torch

from dal3d_tpu_torch.models.builder import build_detector
from dal3d_tpu_torch.ops import banded as tbd
from dal3d_tpu_torch.ops import distance as tdist
from dal3d_tpu_torch.ops import iou_matrix as tiou
from dal3d_tpu_torch.ops import kcenter as tk
from dal3d_tpu_torch.runtime.steps import make_predict_step
from torch_port_utils import (cuda, mk_rulebook, small_cfg, small_gather_cfg,  # noqa: F401
                              small_voxels, t)

pytestmark = pytest.mark.cuda


def _path_weight(kind, rng):
    """[Q, R, Rout] f32 weights of the kind the main path gives K1, built by
    the port's own functions at small widths (brick width 8, 16 channels),
    or a dense / ragged / zero-block weight."""
    from dal3d_tpu_torch.ops import sparse_brick as spb

    def layer(K, cin, cout):
        return torch.from_numpy((rng.randn(K, cin, cout) * 0.1).astype(np.float32))

    if kind == "halo_band":  # subm conv: [9, 10*16, 8*16]
        return spb._halo_band(9, 3, 8, layer(27, 16, 16))
    if kind == "dual":  # the dual gather's weight of the same conv
        return spb._halo_band(9, 3, 8, layer(27, 16, 16)).flip(0).transpose(1, 2).contiguous()
    if kind in ("pad", "pad_valid"):  # halo pad: 0/1 shifts
        return torch.from_numpy(spb._pad_wband_np(8, 16, with_valid=kind == "pad_valid"))
    if kind == "down":  # strided conv 16 -> 32, stride 2, brick width 8 -> 8
        _, meta = spb.downsample_static_meta((11, 32, 64), 8, 3, 2, 1, 8)
        return spb.down_wband(layer(27, 16, 32), 8, 8, meta, spb._pad8(10 * 17))
    Q, R, Rout = {"dense": (9, 288, 256), "zero_blocks": (9, 288, 256),
                  "ragged_600x520": (9, 600, 520), "ragged_776x520": (3, 776, 520),
                  "ragged_516x776": (3, 516, 776), "ragged_656x528": (18, 656, 528)}[kind]
    w = torch.from_numpy((rng.randn(Q, R, Rout) * 0.05).astype(np.float32))
    if kind == "zero_blocks":
        w[2] = 0.0  # a whole tap
        w[0, :32] = 0.0  # the first K-block of a tap
        w[3, 256:] = 0.0  # the last, partial K-block
        w[4, 32:64, 192:] = 0.0  # a K-block under the last column tile only
        w[5, :, :64] = 0.0  # the first column tile of a tap
        w[6, 100:101, 7] = -0.0  # a signed zero inside a zero row
    return w


# weights of the main path, a dense and a zero-block weight, and widths that
# are not multiples of the tiles (M is 1000 throughout, Mb 900)
K1_WEIGHTS = ["dense", "halo_band", "dual", "pad", "pad_valid", "down", "zero_blocks",
              "ragged_600x520", "ragged_776x520", "ragged_516x776", "ragged_656x528"]


@pytest.mark.parametrize("kind", K1_WEIGHTS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_banded_kernel_matches_plain(cuda, dtype, kind):  # noqa: F811
    """bf16: both sum the same bf16 products in f32 and round once, so they
    agree to one bf16 ulp (2**-7 relative); f32: summation order only. The
    kernel walks only the weight blocks that hold a nonzero: on the halo-pad
    shifts, where every output is one product or none, it is bit-equal."""
    rng = np.random.RandomState(5)
    w = _path_weight(kind, rng)
    Q, R, Rout = w.shape
    B, M, Mb = 2, 1000, 900
    idx, hit = mk_rulebook(rng, B, Q, M, Mb, spread=200, miss_p=0.5)
    idx = t(np.where(hit, idx, -1)).to(cuda)
    idx[:, :, 256:384] = -1  # one 128-row block with no hit at all
    idx[:, Q // 2, 512:] = -1  # a tap active in some row blocks only
    table = t(rng.randn(B, Mb, R).astype(np.float32)).to(cuda, dtype)
    w = w.to(cuda, dtype)
    before = tbd.banded_conv.launches
    got = tbd.banded_conv(table, idx, w)
    torch.cuda.synchronize()
    assert tbd.banded_conv.launches == before + 1
    ref = tbd.banded_conv_plain(table, idx, w)
    assert got.shape == ref.shape == (B, M, Rout)
    if kind.startswith("pad"):
        assert torch.equal(got, ref)
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4
    np.testing.assert_allclose(got.float().cpu().numpy(), ref.float().cpu().numpy(),
                               rtol=tol, atol=tol)


def test_banded_kernel_pads_unaligned_widths(cuda):  # noqa: F811
    """R 90 and Rout 306 are padded to the kernel's multiple of 8 and cut
    back; M != Mb."""
    rng = np.random.RandomState(3)
    B, Q, M, Mb, R, Rout = 2, 3, 96, 80, 90, 306
    idx, hit = mk_rulebook(rng, B, Q, M, Mb, spread=10)
    idx = t(np.where(hit, idx, -1)).to(cuda)
    table = t(rng.randn(B, Mb, R).astype(np.float32)).to(cuda)
    w = t(rng.randn(Q, R, Rout).astype(np.float32)).to(cuda)
    got = tbd.banded_conv(table, idx, w)
    assert got.shape == (B, M, Rout)
    np.testing.assert_allclose(got.cpu().numpy(), tbd.banded_conv_plain(table, idx, w).cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


def test_iou_kernel_matches_plain(cuda):  # noqa: F811
    """Same arithmetic, no FMA contraction on either side: atol 1e-5."""
    rng = np.random.RandomState(0)
    G, N = 3, 300
    b = np.zeros((G, N, 5), np.float32)
    b[..., 0:2] = rng.uniform(-40, 40, (G, N, 2))
    b[..., 2:4] = rng.uniform(0.5, 6.0, (G, N, 2))
    b[..., 4] = rng.uniform(-np.pi, np.pi, (G, N))
    b[:, N // 2:] = b[:, :N - N // 2]  # exact duplicates
    b[:, -1] = 0.0  # a zero (padding) box
    rows = tiou._pack_rowdat(t(b).to(cuda))
    before = tiou.iou_matrix.launches
    got = tiou.iou_matrix(rows, rows)
    torch.cuda.synchronize()
    assert tiou.iou_matrix.launches == before + 1
    ref = tiou.iou_matrix_plain(rows, rows)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=1e-5)
    assert float(got[:, -1].abs().max()) == 0.0


def test_predict_on_card_matches_cpu(cuda):  # noqa: F811
    """The whole predict step in f32: kernels on the card vs the plain
    versions on the CPU, same seeded weights and voxels. Detections agree as
    sets (summation order only)."""
    cfg = small_cfg()
    vf, vc, vv = small_voxels(3)
    batch = {"voxel_features": vf, "voxel_coords": vc, "voxel_valid": vv}
    outs = {}
    for dev in ("cpu", "cuda"):
        bundle = build_detector(cfg, device=dev, seed=0)
        outs[dev] = {k: v.float().cpu() if v.is_floating_point() else v.cpu()
                     for k, v in make_predict_step(bundle)(batch).items()}
    a, b = outs["cpu"], outs["cuda"]
    np.testing.assert_allclose(b["embedding"].numpy(), a["embedding"].numpy(),
                               rtol=1e-4, atol=1e-4)
    for i in range(vf.shape[0]):
        va, vb = a["det_valid"][i], b["det_valid"][i]
        assert int(va.sum()) == int(vb.sum()) > 0
        sa, sb = a["scores"][i][va], b["scores"][i][vb]
        oa, ob = torch.argsort(sa, descending=True), torch.argsort(sb, descending=True)
        np.testing.assert_allclose(sb[ob].numpy(), sa[oa].numpy(), atol=1e-4)
        np.testing.assert_allclose(b["box3d_lidar"][i][vb][ob].numpy(),
                                   a["box3d_lidar"][i][va][oa].numpy(), atol=1e-3)
        np.testing.assert_array_equal(b["label_preds"][i][vb][ob].numpy(),
                                      a["label_preds"][i][va][oa].numpy())


# (N, M, C): tile kernel with ragged edges, C off the float4 path, the row
# kernel (N <= 8), and the embedding width
DIST_SHAPES = [(257, 1031, 16), (130, 70, 19), (1, 1031, 512), (8, 333, 30), (600, 2000, 512)]


def _embeddings(N, M, C, seed, cuda):  # noqa: F811
    rng = np.random.RandomState(seed)
    return (t(np.abs(rng.randn(N, C)).astype(np.float32)).to(cuda),
            t(np.abs(rng.randn(M, C)).astype(np.float32)).to(cuda))


@pytest.mark.parametrize("N,M,C", DIST_SHAPES)
def test_l1_kernel_matches_plain(cuda, N, M, C):  # noqa: F811
    """Sums of C non-negative terms in another order: rtol 1e-5."""
    x, y = _embeddings(N, M, C, 0, cuda)
    before = tdist.pairwise_l1.launches
    got = tdist.pairwise_l1(x, y)
    torch.cuda.synchronize()
    assert tdist.pairwise_l1.launches == before + 1 and got.shape == (N, M)
    np.testing.assert_allclose(got.cpu().numpy(), tdist.pairwise_l1_plain(x, y).cpu().numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("N,M,C", DIST_SHAPES)
def test_l2_kernel_matches_plain(cuda, N, M, C):  # noqa: F811
    """Squared distances within 2e-6 of the scale |x|^2 + |y|^2 (the Gram
    expression cancels; the error is that of the three sums). Distances agree
    away from the diagonal, and d(x, x) is small against |x|."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, y = _embeddings(N, M, C, 1, cuda)
    before = tdist.pairwise_l2.launches
    got2 = tdist.pairwise_l2(x, y, squared=True)
    got = tdist.pairwise_l2(x, y)
    torch.cuda.synchronize()
    assert tdist.pairwise_l2.launches == before + 2
    scale = (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
    ref2 = tdist.pairwise_l2_plain(x, y, squared=True)
    assert float(((got2 - ref2).abs() / scale).max()) <= 2e-6
    np.testing.assert_allclose(got.cpu().numpy(), got2.sqrt().cpu().numpy(), rtol=1e-6)
    np.testing.assert_allclose(got.cpu().numpy(), ref2.sqrt().cpu().numpy(), rtol=1e-4)
    d = tdist.pairwise_l2(x, x)
    assert bool(torch.isfinite(d).all()) and float(d.min()) >= 0
    assert float(d.diagonal().max()) <= 1e-2 * float(x.norm(dim=1).min())


def test_distance_kernel_takes_an_unaligned_view(cuda):  # noqa: F811
    base = t(np.random.RandomState(2).rand(1 + 40 * 16).astype(np.float32)).to(cuda)
    x = base[1:].view(40, 16)  # contiguous, 4 bytes off a 16-byte boundary
    got = tdist.pairwise_l1(x[:1], x)
    np.testing.assert_allclose(got.cpu().numpy(), tdist.pairwise_l1_plain(x[:1], x).cpu().numpy(),
                               rtol=1e-5)


@pytest.mark.parametrize("metric", ["l1", "l2"])
def test_streaming_kcenter_on_card_matches_cpu(cuda, metric):  # noqa: F811
    """Each pick of the streaming k-center launches one distance kernel; on
    well-separated random embeddings the card picks what the CPU picks."""
    rng = np.random.RandomState(4)
    n = 300
    f = np.abs(rng.randn(n, 64)).astype(np.float32)
    costs = (0.12 + 0.04 * rng.randint(0, 30, n)).astype(np.float32)
    init = np.full(n, np.inf, np.float32)
    already = np.zeros(n, bool)
    fn = tdist.pairwise_l1 if metric == "l1" else tdist.pairwise_l2
    before = fn.launches
    sel, count, cost = tk.kcenter_features(t(f).to(cuda), t(costs).to(cuda), np.float32(20.0),
                                           t(init).to(cuda), 5, t(already).to(cuda),
                                           max_select=n, metric=metric)
    # one row per kept pick, and one for the pick that crossed the budget
    assert fn.launches - before == count
    ref, rcount, rcost = tk.kcenter_features(t(f), t(costs), np.float32(20.0), t(init), 5,
                                             t(already), max_select=n, metric=metric)
    assert count == rcount > 10 and sel.cpu().tolist() == ref.tolist()
    assert float(cost) == float(rcost)


# --- training: the weight-gradient kernel and the banded backward -----------

def _dw_case(rng, B, Q, M, Mb, R, Rout, dtype, dev, miss_p=0.5):
    idx, hit = mk_rulebook(rng, B, Q, M, Mb, spread=max(Mb // 5, 2), miss_p=miss_p)
    idx = t(np.where(hit, idx, -1)).to(dev)
    table = t(rng.randn(B, Mb, R).astype(np.float32)).to(dev, dtype)
    g = t((rng.randn(B, M, Rout) * 0.1).astype(np.float32)).to(dev, dtype)
    return table, idx, g


# (B, Q, M, Mb, R, Rout): the wrapper cuts the hits into one to a few dozen
# equal shares; a ragged last step; one short share; widths the wrapper pads;
# a single row block; the path's ragged widths (R 600 / 656 / 776, Rout 520 /
# 528) over several shares
DW_SHAPES = [(2, 9, 1000, 900, 288, 256), (1, 3, 130, 130, 64, 72), (2, 3, 96, 80, 90, 306),
             (3, 27, 517, 400, 312, 528), (2, 9, 6016, 6016, 600, 520),
             (2, 3, 3000, 2500, 776, 528), (2, 9, 4000, 4000, 656, 520)]


@pytest.mark.parametrize("pattern", ["random", "sparse"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", DW_SHAPES)
def test_banded_dw_kernel_matches_plain(cuda, shape, dtype, pattern):  # noqa: F811
    """Both sum the same products (exact in f32 for bf16 inputs) in f32, in
    another order: within 1e-4 of the result's scale. The kernel multiplies
    hit rows only; "sparse" leaves tap 0 a single hit row (its dw is one
    exact outer product: bit-equal) and every later tap no hit in its first
    1100 rows, more than a compaction window. Two calls give the same bits."""
    B, Q, M, Mb, R, Rout = shape
    table, idx, g = _dw_case(np.random.RandomState(7), B, Q, M, Mb, R, Rout, dtype, cuda)
    idx[:, 1] = -1  # a tap with no hit at all
    idx[:, :, 64:128] = -1  # a 64-row step with no hit
    if pattern == "sparse":
        rows = torch.arange(B * M, device=cuda).view(B, 1, M)  # flattened (b, m)
        idx = torch.where(rows >= 1100, idx, -1)
        idx[:, 0] = -1
        idx[B - 1, 0, M // 2] = Mb // 3
    before = tbd.banded_dw.launches
    got = tbd.banded_dw(table, idx, g)
    torch.cuda.synchronize()
    assert tbd.banded_dw.launches == before + 1
    assert got.shape == (Q, R, Rout) and got.dtype == torch.float32
    ref = tbd.banded_dw_plain(table, idx, g)
    assert float(got[1].abs().max()) == 0.0
    if pattern == "sparse":
        assert torch.equal(got[0], ref[0]) and float(got[0].abs().max()) > 0
    scale = float(ref.abs().max())
    assert scale > 0 and float((got - ref).abs().max()) <= 1e-4 * scale
    again = tbd.banded_dw(table, idx, g)  # ordered reduction: the same bits every time
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("symmetric", [True, False])
def test_banded_backward_on_card_matches_cpu(cuda, symmetric, dtype):  # noqa: F811
    """The autograd op on the card (K1 / scatter input gradient, K3 weight
    gradient) against the same op on the CPU (plain versions)."""
    rng = np.random.RandomState(11)
    B, Q, M, R, Rout = 2, 3, 300, 64, 40
    if symmetric:  # taps (-2, self, +2) over M rows
        m = np.arange(M)
        idx = np.stack([np.where(m >= 2, m - 2, -1), m, np.where(m < M - 2, m + 2, -1)])
        idx = np.tile(idx[None], (B, 1, 1)).astype(np.int32)
        idx[0, 0, 10] = idx[0, 2, 8] = -1  # a dual pair dropped together
        Mb = M
    else:
        Mb = 250
        idx0, hit = mk_rulebook(rng, B, Q, M, Mb, spread=30)
        idx = np.where(hit, idx0, -1).astype(np.int32)
    table = rng.randn(B, Mb, R).astype(np.float32)
    w = (rng.randn(Q, R, Rout) * 0.1).astype(np.float32)
    cot = rng.randn(B, M, Rout).astype(np.float32)
    grads = {}
    for dev in ("cpu", "cuda"):
        tb = t(table).to(dev, dtype).requires_grad_(True)
        wt = t(w).to(dev).requires_grad_(True)  # f32 parameter, cast inside the op
        out = tbd.banded_gather_matmul(tb, wt, t(idx).to(dev), symmetric=symmetric)
        (out.float() * t(cot).to(dev)).sum().backward()
        grads[dev] = (tb.grad.float().cpu(), wt.grad.float().cpu())
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-4
    for a, b in zip(grads["cpu"], grads["cuda"]):
        assert float((a - b).abs().max()) <= tol * float(a.abs().max())


def test_train_step_on_card_matches_cpu(cuda):  # noqa: F811
    """One f32 train step: kernels on the card vs plain versions on the CPU,
    same seeded weights, voxels and boxes: the logs within 1e-3 relative,
    every updated batch statistic within 1e-4, the gradient as a whole within
    2e-2 of its norm (single parameters move more when a ReLU unit within
    rounding of zero changes side between the devices; the kernels are held
    tightly one by one above)."""
    from dal3d_tpu_torch.runtime.steps import make_train_step
    from dal3d_tpu_torch.solver.optim import OneCycleSchedule, build_optimizer
    from torch_port_utils import small_gt

    cfg = small_cfg()
    vf, vc, vv = small_voxels(3)
    gt_boxes, gt_classes = small_gt(cfg, 3)
    batch = {"voxel_features": vf, "voxel_coords": vc, "voxel_valid": vv,
             "gt_boxes": gt_boxes, "gt_classes": gt_classes}
    logs, stats, grads = {}, {}, {}
    for dev in ("cpu", "cuda"):
        bundle = build_detector(cfg, device=dev, seed=0)
        opt = build_optimizer(OneCycleSchedule(total_steps=10)).init(
            bundle.model.named_parameters())
        k1, k3 = tbd.banded_conv.launches, tbd.banded_dw.launches
        out = make_train_step(bundle, opt)(batch)
        logs[dev] = {k: float(v) for k, v in out.items()}
        stats[dev] = {k: v.cpu() for k, v in bundle.model.state_dict().items() if "running" in k}
        grads[dev] = {k: p.grad.double().cpu() for k, p in bundle.model.named_parameters()}
        if dev == "cuda":
            # 42 forward launches + 36 dual gathers; one weight gradient per trained conv
            assert tbd.banded_conv.launches - k1 == 78
            assert tbd.banded_dw.launches - k3 == 21
    assert logs["cpu"]["num_pos"] == logs["cuda"]["num_pos"] > 0
    for k, v in logs["cpu"].items():
        assert abs(logs["cuda"][k] - v) <= 1e-3 * abs(v), (k, v, logs["cuda"][k])
    for k, v in stats["cpu"].items():
        np.testing.assert_allclose(stats["cuda"][k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    num = sum(float(((grads["cuda"][k] - g) ** 2).sum()) for k, g in grads["cpu"].items())
    den = sum(float((g ** 2).sum()) for g in grads["cpu"].values())
    assert den > 0 and (num / den) ** 0.5 <= 2e-2, (num / den) ** 0.5


# the fused gather-GEMM (K4): (B, N, Cin, K, M, Cout, hit fraction). The first
# is tests/test_pallas_gather.py's case; then the stem's Cin 5 with M not a
# multiple of any tile, the encoder's 64- and 128-wide convs, M = 1, and a
# Cout of 200 (padded to 256: two column tiles)
GATHER_GEMM_SHAPES = [
    (2, 600, 16, 5, 1500, 32, 0.6),
    (1, 300, 5, 27, 777, 16, 0.5),
    (2, 400, 64, 27, 1000, 64, 0.3),
    (2, 500, 128, 27, 333, 128, 0.5),
    (1, 50, 32, 3, 1, 128, 1.0),
    (2, 100, 12, 4, 300, 200, 0.5),
]


@pytest.mark.parametrize("shape", GATHER_GEMM_SHAPES)
def test_gather_gemm_kernel_matches_plain(cuda, shape):  # noqa: F811
    """f32 FMAs in another order than the plain version's matmuls: within
    1e-5 of the output's scale. Rows 100-299 have no hit at all (zero rows);
    the misses point at arbitrary rows, which must add nothing."""
    from dal3d_tpu_torch.ops import gather as tg

    B, N, Cin, K, M, Cout, hit_p = shape
    rng = np.random.RandomState(sum(shape[:6]))
    feats = t(rng.randn(B, N, Cin).astype(np.float32)).to(cuda)
    idx = t(rng.randint(0, N, (B, K, M)).astype(np.int32)).to(cuda)
    hit = t(rng.rand(B, K, M) < hit_p).to(cuda)
    hit[:, :, 100:300] = False
    w = t((rng.randn(K, Cin, Cout) * 0.1).astype(np.float32)).to(cuda)
    before = tg.gather_gemm.launches
    got = tg.gather_gemm(feats, idx, hit, w)
    torch.cuda.synchronize()
    assert tg.gather_gemm.launches == before + 1
    assert got.shape == (B, M, Cout) and got.dtype == torch.float32
    ref = tg.gather_gemm_plain(feats, idx, hit, w)
    scale = max(float(ref.abs().max()), 1e-30)
    assert float((got - ref).abs().max()) <= 1e-5 * scale
    if M > 100:
        assert float(got[:, 100:300].abs().max()) == 0.0


@pytest.mark.parametrize("dtype,C,M", [(torch.float32, 128, 400), (torch.float32, 5, 33),
                                       (torch.bfloat16, 3, 1), (torch.float32, 128, 1)])
def test_gather_rows_kernel_matches_plain(cuda, dtype, C, M):  # noqa: F811
    """A copy: bit-equal to table[idx], for 16-, 4- and 2-byte row pieces."""
    from dal3d_tpu_torch.ops import gather as tg

    rng = np.random.RandomState(C + M)
    table = t(rng.randn(1000, C).astype(np.float32)).to(cuda, dtype)
    idx = t(rng.randint(0, 1000, M).astype(np.int32)).to(cuda)
    before = tg.gather_rows.launches
    got = tg.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert tg.gather_rows.launches == before + 1
    assert got.dtype == dtype and torch.equal(got, tg.gather_rows_plain(table, idx))


# the redesigned K4 (3xTF32 on the tensor cores, rows grouped by hit mask):
# (Cin, Cout) of every launch type of the BEVFusion encoder, the stem's Cin 5,
# and Cout 200 (two column tiles of 128)
K4_WIDTHS = [(5, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 64), (64, 128), (128, 128),
             (128, 200)]


@pytest.mark.parametrize("Cin,Cout", K4_WIDTHS)
def test_gather_gemm_kernel_random_rows(cuda, Cin, Cout):  # noqa: F811
    """Rows in random order with 19 % hits, M = 4000 (no multiple of a
    tile), 500 rows without a hit (whole tiles that miss, sorted first by
    the plan), features spread over 1e-3..1e3: within 1e-5 of scale, the
    rows without a hit exactly 0, the same bits on a second call and with
    the plan made by the caller."""
    from dal3d_tpu_torch.ops import gather as tg

    rng = np.random.RandomState(Cin * 1000 + Cout)
    B, N, K, M = 2, 5000, 27, 4000
    f = rng.randn(B, N, Cin) * 10.0 ** rng.uniform(-3, 3, (B, N, Cin))
    feats = t(f.astype(np.float32)).to(cuda)
    idx = t(rng.randint(0, N, (B, K, M)).astype(np.int32)).to(cuda)
    hit = t(rng.rand(B, K, M) < 0.19).to(cuda)
    hit[:, :, 1000:1500] = False
    w = t((rng.randn(K, Cin, Cout) * 0.1).astype(np.float32)).to(cuda)
    got = tg.gather_gemm(feats, idx, hit, w)
    torch.cuda.synchronize()
    ref = tg.gather_gemm_plain(feats, idx, hit, w)
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-5 * scale
    assert float(got[:, 1000:1500].abs().max()) == 0.0
    assert torch.equal(got, tg.gather_gemm(feats, idx, hit, w))
    assert torch.equal(got, tg.gather_gemm(feats, idx, hit, w, tg.gather_plan(idx, hit)))


@pytest.mark.parametrize("Cout", [16, 32, 64, 128])
def test_gather_gemm_kernel_l0_like_rulebook(cuda, Cout):  # noqa: F811
    """A subm rulebook of surface voxels in random order (about 10 % hits),
    as the L0 convs see: within 1e-5 of scale, repeat bit-equal."""
    from dal3d_tpu_torch.ops import gather as tg
    from test_torch_gather_tf32 import surface_rulebook

    idx, hit = (x.to(cuda) for x in surface_rulebook(Cout))
    rng = np.random.RandomState(Cout)
    Cin = 16 if Cout <= 32 else Cout
    feats = t(rng.randn(1, idx.shape[2], Cin).astype(np.float32)).to(cuda)
    w = t((rng.randn(27, Cin, Cout) * 0.1).astype(np.float32)).to(cuda)
    got = tg.gather_gemm(feats, idx, hit, w)
    ref = tg.gather_gemm_plain(feats, idx, hit, w)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(got, tg.gather_gemm(feats, idx, hit, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_rows_kernel_reads_strided_views(cuda, dtype):  # noqa: F811
    """The [B, H*W, C] view of an NCHW map read in place (element-strided
    rows), an index past the rows giving a zero row; rows that are not
    16-byte aligned (a column slice of a [N, 6] table, a 5-wide bf16 row):
    bit-equal to table[idx] on a contiguous copy."""
    from dal3d_tpu_torch.ops import gather as tg

    rng = np.random.RandomState(7)
    x = t(rng.randn(2, 128, 30, 30).astype(np.float32)).to(cuda, dtype)
    view = x.permute(0, 2, 3, 1).reshape(2, 900, 128)
    rows = t(rng.randint(0, 1800, 400).astype(np.int32)).to(cuda)
    before = tg.gather_rows.launches
    got = tg.gather_rows(view, rows)
    torch.cuda.synchronize()
    assert tg.gather_rows.launches == before + 1
    assert torch.equal(got, view.reshape(1800, 128)[rows.long()])
    assert torch.equal(got, tg.gather_rows_plain(view, rows))
    past = torch.tensor([5, 1800, -1], dtype=torch.int32, device=cuda)
    z = tg.gather_rows(view, past)
    assert torch.equal(z[0], view.reshape(1800, 128)[5]) and float(z[1:].abs().max()) == 0.0
    for width, cut in ((6, 1), (5, 0), (9, 3)):
        tbl = t(rng.randn(1000, width).astype(np.float32)).to(cuda, dtype)[:, cut:]
        ix = t(rng.randint(0, 1000, 77).astype(np.int32)).to(cuda)
        assert torch.equal(tg.gather_rows(tbl, ix), tbl.contiguous()[ix.long()])


def test_gather_gemm_kernel_refuses_other_types(cuda):  # noqa: F811
    """The kernels take f32 or bf16 features and weights of one type and an
    int32 rulebook: f16, f64 and mixed operands raise, before any launch."""
    from dal3d_tpu_torch.ops import gather as tg

    feats = torch.zeros(1, 8, 8, device=cuda)
    idx = torch.zeros(1, 2, 4, dtype=torch.int32, device=cuda)
    hit = torch.ones(1, 2, 4, dtype=torch.bool, device=cuda)
    w = torch.zeros(2, 8, 16, device=cuda)
    before = (tg.gather_gemm.launches, tg.gather_gemm_bf16.launches)
    for fd, wd in ((torch.float16, torch.float16), (torch.float64, torch.float64),
                   (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)):
        with pytest.raises(TypeError):
            tg.gather_gemm(feats.to(fd), idx, hit, w.to(wd))
    with pytest.raises(ValueError):
        tg.gather_gemm(feats, idx.long(), hit, w)
    assert (tg.gather_gemm.launches, tg.gather_gemm_bf16.launches) == before


BF16_ULP = 2.0 ** -7  # one bf16 ulp at a tensor's scale (K1's rule)


def _rel(got, ref):
    return float((got.float() - ref.float()).abs().max()) / max(float(ref.float().abs().max()),
                                                                1e-30)


@pytest.mark.parametrize("Cin,Cout", K4_WIDTHS)
def test_gather_gemm_bf16_kernel_random_rows(cuda, Cin, Cout):  # noqa: F811
    """The bf16 K4 (bf16 products, f32 sums, one rounding) on the random
    rows of the f32 test above (19 % hits, 500 rows without one, features
    over 1e-3..1e3): within one bf16 ulp of the plain version's scale, the
    rows without a hit exactly 0, bf16 out, the same bits on a second call
    and on the sorted plan, one launch each on the bf16 counter."""
    from dal3d_tpu_torch.ops import gather as tg

    rng = np.random.RandomState(Cin * 1000 + Cout)
    B, N, K, M = 2, 5000, 27, 4000
    f = rng.randn(B, N, Cin) * 10.0 ** rng.uniform(-3, 3, (B, N, Cin))
    feats = t(f.astype(np.float32)).to(cuda, torch.bfloat16)
    idx = t(rng.randint(0, N, (B, K, M)).astype(np.int32)).to(cuda)
    hit = t(rng.rand(B, K, M) < 0.19).to(cuda)
    hit[:, :, 1000:1500] = False
    w = t((rng.randn(K, Cin, Cout) * 0.1).astype(np.float32)).to(cuda, torch.bfloat16)
    n32, n16 = tg.gather_gemm.launches, tg.gather_gemm_bf16.launches
    got = tg.gather_gemm(feats, idx, hit, w)
    torch.cuda.synchronize()
    assert (tg.gather_gemm.launches - n32, tg.gather_gemm_bf16.launches - n16) == (0, 1)
    assert got.dtype == torch.bfloat16 and got.shape == (B, M, Cout)
    ref = tg.gather_gemm_plain(feats, idx, hit, w)
    assert _rel(got, ref) <= BF16_ULP
    assert float(got[:, 1000:1500].float().abs().max()) == 0.0
    assert torch.equal(got, tg.gather_gemm(feats, idx, hit, w))
    assert torch.equal(got, tg.gather_gemm(feats, idx, hit, w, tg.gather_plan(idx, hit)))


@pytest.mark.parametrize("Cout", [16, 32, 64, 128])
def test_gather_gemm_bf16_kernel_l0_like_rulebook(cuda, Cout):  # noqa: F811
    """The bf16 K4 on the surface rulebook of the f32 test above: within
    one bf16 ulp of scale, repeat bit-equal."""
    from dal3d_tpu_torch.ops import gather as tg
    from test_torch_gather_tf32 import surface_rulebook

    idx, hit = (x.to(cuda) for x in surface_rulebook(Cout))
    rng = np.random.RandomState(Cout)
    Cin = 16 if Cout <= 32 else Cout
    feats = t(rng.randn(1, idx.shape[2], Cin).astype(np.float32)).to(cuda, torch.bfloat16)
    w = t((rng.randn(27, Cin, Cout) * 0.1).astype(np.float32)).to(cuda, torch.bfloat16)
    got = tg.gather_gemm(feats, idx, hit, w)
    assert _rel(got, tg.gather_gemm_plain(feats, idx, hit, w)) <= BF16_ULP
    assert torch.equal(got, tg.gather_gemm(feats, idx, hit, w))


# the redesigned bf16 K4 and K4-dW (bf16 wgmma from swizzled shared memory):
# the input gradients' (Cin, Cout), the forward's reversed, with the
# transposed dW tiles' (Cout > Cin) among the forward's own
BF16_DX_WIDTHS = [(32, 16), (64, 32), (128, 64)]


def _bf16_rulebook(rng, B, N, K, M, hit_p):
    idx = t(rng.randint(0, N, (B, K, M)).astype(np.int32))
    hit = t(rng.rand(B, K, M) < hit_p)
    return idx, hit


@pytest.mark.parametrize("M", [1, 63, 65, 191, 1000])
@pytest.mark.parametrize("Cin,Cout", [(16, 16), (32, 64), (128, 128)])
def test_gather_gemm_bf16_kernel_ragged_rows(cuda, Cin, Cout, M):  # noqa: F811
    """The bf16 K4 on M rows that fill no whole 64-row warpgroup tile (and
    M = 1): within one bf16 ulp of scale of the plain version, bit-equal on
    a repeat and on the sorted plan; its dW likewise."""
    from dal3d_tpu_torch.ops import gather as tg

    rng = np.random.RandomState(Cin + Cout + M)
    B, N, K = 2, 700, 27
    feats = t(rng.randn(B, N, Cin).astype(np.float32)).to(cuda, torch.bfloat16)
    idx, hit = (x.to(cuda) for x in _bf16_rulebook(rng, B, N, K, M, 0.3))
    w = t((rng.randn(K, Cin, Cout) * 0.1).astype(np.float32)).to(cuda, torch.bfloat16)
    got = tg.gather_gemm(feats, idx, hit, w)
    assert got.shape == (B, M, Cout)
    assert _rel(got, tg.gather_gemm_plain(feats, idx, hit, w)) <= BF16_ULP
    assert torch.equal(got, tg.gather_gemm(feats, idx, hit, w))
    assert torch.equal(got, tg.gather_gemm(feats, idx, hit, w, tg.gather_plan(idx, hit)))
    g = t(rng.randn(B, M, Cout).astype(np.float32)).to(cuda, torch.bfloat16)
    dw = tg.gather_dw(feats, idx, hit, g)
    assert _rel(dw, tg.gather_dw_plain(feats, idx, hit, g)) <= BF16_ULP
    assert torch.equal(dw, tg.gather_dw(feats, idx, hit, g))


@pytest.mark.parametrize("Cin,Cout", BF16_DX_WIDTHS)
def test_gather_gemm_bf16_kernel_dx_widths(cuda, Cin, Cout):  # noqa: F811
    """The input gradients' widths of the CBGS gather backbone (the strided
    convs' dX: Cin > Cout) on random rows with 19 % hits, through the bf16
    K4 and the bf16 K4-dW: within one bf16 ulp of scale, repeat bit-equal."""
    from dal3d_tpu_torch.ops import gather as tg

    rng = np.random.RandomState(Cin * 7 + Cout)
    B, N, K, M = 2, 3000, 27, 2500
    feats = t(rng.randn(B, N, Cin).astype(np.float32)).to(cuda, torch.bfloat16)
    idx, hit = (x.to(cuda) for x in _bf16_rulebook(rng, B, N, K, M, 0.19))
    w = t((rng.randn(K, Cin, Cout) * 0.1).astype(np.float32)).to(cuda, torch.bfloat16)
    got = tg.gather_gemm(feats, idx, hit, w)
    assert _rel(got, tg.gather_gemm_plain(feats, idx, hit, w)) <= BF16_ULP
    assert torch.equal(got, tg.gather_gemm(feats, idx, hit, w))
    g = t(rng.randn(B, M, Cout).astype(np.float32)).to(cuda, torch.bfloat16)
    dw = tg.gather_dw(feats, idx, hit, g, tg.gather_plan(idx, hit))
    assert _rel(dw, tg.gather_dw_plain(feats, idx, hit, g)) <= BF16_ULP
    assert torch.equal(dw, tg.gather_dw(feats, idx, hit, g, tg.gather_plan(idx, hit)))


@pytest.mark.parametrize("Cin,Cout", [(16, 16), (16, 32), (64, 64), (128, 128)])
def test_gather_bf16_kernels_single_and_empty_taps(cuda, Cin, Cout):  # noqa: F811
    """K = 27 taps of which tap 3 is hit by one row only and taps 0, 13 and
    26 by none: the bf16 K4 within one bf16 ulp of scale (the rows that hit
    nothing exactly 0), the bf16 K4-dW too, with exact zeros for the empty
    taps and tap 3 equal to that one row's outer product, rounded once."""
    from dal3d_tpu_torch.ops import gather as tg

    rng = np.random.RandomState(Cin + 3 * Cout)
    B, N, K, M = 1, 2000, 27, 1500
    idx, hit = _bf16_rulebook(rng, B, N, K, M, 0.05)
    hit[:, [0, 13, 26]] = False
    hit[:, 3] = False
    hit[0, 3, 777] = True
    hit[:, :, 1200:] = False
    idx, hit = idx.to(cuda), hit.to(cuda)
    feats = t(rng.randn(B, N, Cin).astype(np.float32)).to(cuda, torch.bfloat16)
    w = t((rng.randn(K, Cin, Cout) * 0.1).astype(np.float32)).to(cuda, torch.bfloat16)
    for plan in (None, tg.gather_plan(idx, hit)):
        got = tg.gather_gemm(feats, idx, hit, w, plan)
        assert _rel(got, tg.gather_gemm_plain(feats, idx, hit, w)) <= BF16_ULP
        assert float(got[:, 1200:].float().abs().max()) == 0.0
        g = t(rng.randn(B, M, Cout).astype(np.float32)).to(cuda, torch.bfloat16)
        dw = tg.gather_dw(feats, idx, hit, g, plan)
        assert _rel(dw, tg.gather_dw_plain(feats, idx, hit, g)) <= BF16_ULP
        assert float(dw[[0, 13, 26]].float().abs().max()) == 0.0
        one = feats[0, idx[0, 3, 777].long()].float()[:, None] * g[0, 777].float()[None, :]
        assert torch.equal(dw[3], one.to(torch.bfloat16))
        assert torch.equal(dw, tg.gather_dw(feats, idx, hit, g, plan))


@pytest.mark.parametrize("Cin,Cout", [(16, 16), (64, 64), (128, 128)])
def test_gather_dw_bf16_kernel_longest_tap(cuda, Cin, Cout):  # noqa: F811
    """The CBGS L0's longest reduction: the centre tap of a submanifold
    conv hit by every one of 2 x 60000 positions, positive features and g
    (a truncating chain would drift toward zero), on the sorted plan:
    within one bf16 ulp of scale of the plain version, repeat bit-equal."""
    from dal3d_tpu_torch.ops import gather as tg

    rng = np.random.RandomState(Cin * 3 + Cout)
    B, N, K, M = 2, 60000, 3, 60000
    idx = t(rng.randint(0, N, (B, K, M)).astype(np.int32)).to(cuda)
    hit = t(rng.rand(B, K, M) < 0.1).to(cuda)
    hit[:, 1] = True
    feats = t(rng.rand(B, N, Cin).astype(np.float32)).to(cuda, torch.bfloat16)
    g = t(rng.rand(B, M, Cout).astype(np.float32)).to(cuda, torch.bfloat16)
    plan = tg.gather_plan(idx, hit)
    got = tg.gather_dw(feats, idx, hit, g, plan)
    assert _rel(got, tg.gather_dw_plain(feats, idx, hit, g)) <= BF16_ULP
    assert torch.equal(got, tg.gather_dw(feats, idx, hit, g, plan))


def test_gather_bf16_tile_mirrors_match_the_build(cuda):  # noqa: F811
    """The launch arithmetic's copies of the bf16 kernels' tile constants
    (``gemm_tile_rows(cout, True)``, which ``gemm_walk`` walks, and
    ``_dw_bf16_blocks_per_sm``, which sizes the dW shares) against the
    constants the built kernels use, for every tile shape."""
    from dal3d_tpu_torch.ops import gather as tg

    for cout in (16, 32, 64, 128, 256):
        assert tg.gemm_tile_rows(cout, True) == (tg.built_bf16_tile(0, cout),
                                                 tg.built_bf16_tile(1, cout)), cout
    for ti in (16, 32, 64, 128):
        for to in (16, 32, 64, 128):
            assert tg._dw_bf16_blocks_per_sm(ti, to) == tg.built_bf16_tile(2, ti, to), (ti, to)


# --- the redesigned K7 (3xTF32 wgmma) and K2 (exact cull) --------------------

def _l2_check(x, y):
    """One K7 call against pairwise_l2_plain at the existing tolerances
    (squared distances within 2e-6 of |x|^2 + |y|^2, distances 1e-4 relative
    away from the diagonal), bit-equal on a repeat; one launch a call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    before = tdist.pairwise_l2.launches
    got2 = tdist.pairwise_l2(x, y, squared=True)
    got = tdist.pairwise_l2(x, y)
    again = tdist.pairwise_l2(x, y)
    torch.cuda.synchronize()
    assert tdist.pairwise_l2.launches == before + 3
    assert got.shape == (x.shape[0], y.shape[0]) and bool(torch.isfinite(got).all())
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    scale = (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
    ref2 = tdist.pairwise_l2_plain(x, y, squared=True)
    assert float(((got2 - ref2).abs() / scale).max()) <= 2e-6
    ref = ref2.sqrt()
    far = ref > 0.1 * scale.sqrt()
    assert float(((got - ref).abs() / ref.clamp(min=1e-30))[far].max()) <= 1e-4


# ragged N and M around the 128-row tiles, C on and off the 32-float k tile
L2_TF32_SHAPES = [(9, 1031, 512), (257, 1031, 16), (1031, 257, 500), (1031, 9, 512),
                  (257, 9, 500), (130, 2000, 16)]


@pytest.mark.parametrize("N,M,C", L2_TF32_SHAPES)
def test_l2_tf32_kernel_matches_plain(cuda, N, M, C):  # noqa: F811
    x, y = _embeddings(N, M, C, 11, cuda)
    _l2_check(x, y)


def test_l2_tf32_kernel_reads_views(cuda):  # noqa: F811
    """The pre-pass reads x through its strides: an unaligned contiguous
    view, every other column of a wider matrix, a transposed one, and x is
    y (split once; the diagonal is rounding noise)."""
    rng = np.random.RandomState(12)
    base = t(np.abs(rng.randn(1 + 300 * 500)).astype(np.float32)).to(cuda)
    x = base[1:].view(300, 500)  # 4 bytes off a 16-byte boundary
    y = t(np.abs(rng.randn(700, 1000)).astype(np.float32)).to(cuda)[:, ::2]
    _l2_check(x, y)
    z = t(np.abs(rng.randn(500, 260)).astype(np.float32)).to(cuda).T  # [260, 500], strides (1, 260)
    _l2_check(z, y.contiguous())
    _l2_check(x, x)
    d = tdist.pairwise_l2(x, x)
    assert float(d.diagonal().max()) <= 1e-2 * float(x.norm(dim=1).min())


def _iou_boxes(kind, rng, G=3, N=400):
    b = np.zeros((G, N, 5), np.float32)
    b[..., 2:4] = rng.uniform(0.4, 12.0, (G, N, 2))
    b[..., 4] = rng.uniform(-np.pi, np.pi, (G, N))
    if kind == "spread":  # uniform over +-50 m: a few percent survive
        b[..., :2] = rng.uniform(-50, 50, (G, N, 2))
    elif kind == "clustered":  # NMS-like: jittered copies of 10 objects
        b[..., :2] = rng.uniform(-40, 40, (G, 10, 2))[:, rng.randint(0, 10, N)]
        b[..., :2] += rng.normal(0, 0.5, (G, N, 2))
    elif kind == "all_culled":  # a 40 m grid: only a box and itself meet
        g = np.arange(N)
        b[..., 0], b[..., 1] = (g % 20) * 40.0 - 400.0, (g // 20) * 40.0 - 400.0
    elif kind == "all_surviving":  # every disc overlaps every other
        b[..., :2] = rng.uniform(-0.3, 0.3, (G, N, 2))
    elif kind == "zero_padded":  # the NMS pads its candidate slots with zeros
        b[..., :2] = rng.uniform(-50, 50, (G, N, 2))
        b[:, N // 2:] = 0.0
    return b


@pytest.mark.parametrize("kind", ["spread", "clustered", "all_culled", "all_surviving",
                                  "zero_padded"])
def test_iou_kernel_cull_is_exact(cuda, kind):  # noqa: F811
    """Bit-equal to the plain version (max error 0), on rows is cols as the
    NMS calls it (the mirrored route), on a copy of the rows and on two
    record sets; the cull covers what it should."""
    rng = np.random.RandomState(len(kind))
    rows = tiou._pack_rowdat(t(_iou_boxes(kind, rng)).to(cuda))
    other = tiou._pack_rowdat(t(_iou_boxes(kind, rng, N=333)).to(cuda))
    for r, c in ((rows, rows), (rows, rows.clone()), (rows, other), (other, rows)):
        before = tiou.iou_matrix.launches
        got = tiou.iou_matrix(r, c)
        torch.cuda.synchronize()
        assert tiou.iou_matrix.launches == before + 1
        ref = tiou.iou_matrix_plain(r, c)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), \
            float((got - ref).abs().max())
    cull = tiou.iou_cull_plain(rows, rows)
    eye = torch.eye(rows.shape[1], dtype=torch.bool, device=cuda)
    if kind == "all_culled":
        assert bool(cull[:, ~eye].all())
    if kind == "all_surviving":
        assert not bool(cull.any())
    if kind == "zero_padded":
        assert bool(cull[:, 200:].all()) and float(got[:, :, 200:].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the gather engine's gradients (K4 dX, K4-dW, K5's backward) and the
# Hungarian assignment kernel
# ---------------------------------------------------------------------------

# (Cin, Cout) of every conv of the BEVFusion encoder (the stem's Cin 5 padded
# to 8), and a width of no tile
DW_WIDTHS = [(8, 16), (16, 16), (16, 32), (32, 32), (32, 64), (64, 64), (64, 128), (128, 128),
             (12, 20)]


@pytest.mark.parametrize("Cin,Cout", DW_WIDTHS)
def test_gather_dw_kernel_matches_plain(cuda, Cin, Cout):  # noqa: F811
    """K4-dW on random rows with 19 % hits and 500 positions without one,
    on the rows-in-order plan and on the sorted plan: within 1e-5 of the
    result's scale (3xTF32 products, f32 sums in another order than the
    plain einsum), the same bits on a repeat; a tap without a hit gives
    exact zeros."""
    from dal3d_tpu_torch.ops import gather as tg

    rng = np.random.RandomState(Cin * 100 + Cout)
    B, N, K, M = 2, 3000, 27, 2500
    feats = t(rng.randn(B, N, Cin).astype(np.float32)).to(cuda)
    idx = t(rng.randint(0, N, (B, K, M)).astype(np.int32)).to(cuda)
    hit = t(rng.rand(B, K, M) < 0.19).to(cuda)
    hit[:, :, 1000:1500] = False
    hit[:, 5] = False
    g = t(rng.randn(B, M, Cout).astype(np.float32)).to(cuda)
    ref = tg.gather_dw_plain(feats, idx, hit, g)
    before = tg.gather_dw.launches
    for plan in (None, tg.gather_plan(idx, hit)):
        got = tg.gather_dw(feats, idx, hit, g, plan)
        torch.cuda.synchronize()
        assert got.shape == (K, Cin, Cout) and got.dtype == torch.float32
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= 1e-5 * scale
        assert float(got[5].abs().max()) == 0.0
        assert torch.equal(got, tg.gather_dw(feats, idx, hit, g, plan))
    assert tg.gather_dw.launches == before + 4


@pytest.mark.parametrize("Cin,Cout", DW_WIDTHS)
def test_gather_dw_bf16_kernel_matches_plain(cuda, Cin, Cout):  # noqa: F811
    """The bf16 K4-dW (bf16 wgmma, f32 sums, dW rounded once) on the
    random rows of the f32 test above, on both plans: bf16 dW within one
    bf16 ulp of the plain version's scale, the same bits on a repeat, a tap
    without a hit exact zeros, the launches on the bf16 counter."""
    from dal3d_tpu_torch.ops import gather as tg

    rng = np.random.RandomState(Cin * 100 + Cout)
    B, N, K, M = 2, 3000, 27, 2500
    feats = t(rng.randn(B, N, Cin).astype(np.float32)).to(cuda, torch.bfloat16)
    idx = t(rng.randint(0, N, (B, K, M)).astype(np.int32)).to(cuda)
    hit = t(rng.rand(B, K, M) < 0.19).to(cuda)
    hit[:, :, 1000:1500] = False
    hit[:, 5] = False
    g = t(rng.randn(B, M, Cout).astype(np.float32)).to(cuda, torch.bfloat16)
    ref = tg.gather_dw_plain(feats, idx, hit, g)
    assert ref.dtype == torch.bfloat16
    n32, n16 = tg.gather_dw.launches, tg.gather_dw_bf16.launches
    for plan in (None, tg.gather_plan(idx, hit)):
        got = tg.gather_dw(feats, idx, hit, g, plan)
        torch.cuda.synchronize()
        assert got.shape == (K, Cin, Cout) and got.dtype == torch.bfloat16
        assert _rel(got, ref) <= BF16_ULP
        assert float(got[5].float().abs().max()) == 0.0
        assert torch.equal(got, tg.gather_dw(feats, idx, hit, g, plan))
    assert (tg.gather_dw.launches - n32, tg.gather_dw_bf16.launches - n16) == (0, 4)


@pytest.mark.parametrize("Cin,Cout", [(64, 128), (16, 16), (128, 128)])
def test_gather_dw_bf16_kernel_long_reduction(cuda, Cin, Cout):  # noqa: F811
    """One tap hit by every one of 20480 positions with positive features
    and g (a sum through the tensor cores' truncating accumulator would
    drift), another by a tenth: within one bf16 ulp of scale, repeat
    bit-equal."""
    from dal3d_tpu_torch.ops import gather as tg

    rng = np.random.RandomState(Cin + Cout)
    B, N, K, M = 1, 4000, 2, 20480
    hit = np.zeros((B, K, M), bool)
    hit[:, 0] = True
    hit[:, 1] = rng.rand(B, M) < 0.1
    idx = t(rng.randint(0, N, (B, K, M)).astype(np.int32)).to(cuda)
    feats = t(rng.rand(B, N, Cin).astype(np.float32)).to(cuda, torch.bfloat16)
    g = t(rng.rand(B, M, Cout).astype(np.float32)).to(cuda, torch.bfloat16)
    hit = t(hit).to(cuda)
    got = tg.gather_dw(feats, idx, hit, g)
    ref = tg.gather_dw_plain(feats, idx, hit, g)
    assert _rel(got, ref) <= BF16_ULP
    assert torch.equal(got, tg.gather_dw(feats, idx, hit, g))


def _dw_direct(tg, feats, rb, g, shares, cps):
    """One launch of the dW kernel's C entry with the chunk shares given
    (the wrapper chooses its own): features [B, N, Cin], rulebook [B, K, M]
    (-1 = miss, rows in order), g [B, M, Cout] -> dW [K, Cin, Cout]."""
    from dal3d_tpu_torch.ops import _build

    B, N, Cin = feats.shape
    K, M, Cout = rb.shape[1], rb.shape[2], g.shape[-1]
    dw = torch.empty(K, Cin, Cout, dtype=torch.float32, device=feats.device)
    part = torch.empty(shares * K * Cin * Cout, dtype=torch.float32, device=feats.device)
    _build.function("gather", "gather_dw_f32", tg._DW_ARGS, "gather_dw")(
        feats.device, feats.data_ptr(), rb.data_ptr(), 0, g.data_ptr(), dw.data_ptr(),
        part.data_ptr(), B, N, Cin, K, M, Cout, shares, cps)
    return dw


@pytest.mark.parametrize("Cin,Cout", [(64, 128), (64, 64), (128, 128), (16, 16), (32, 64)])
@pytest.mark.parametrize("kind", ["one_chunk", "long_tap", "lists_of_1", "lists_of_2"])
def test_gather_dw_kernel_long_reduction_and_short_lists(cuda, kind, Cin, Cout):  # noqa: F811
    """K4-dW where its ring and its sums are stressed, within the same 1e-5
    of scale as above and bit-equal on a repeat: one chunk (the transpose
    and split into the swizzled K-major tiles read back by one wgmma
    chunk); one tap hit by every one of 20480 positions with positive
    features and g, where a sum through the tensor cores' truncating
    accumulator would drift; and shares whose lists of hit chunks are
    shorter than the ring's stages (1 and 2 of each share's 10 chunks hit
    tap 0, none hits tap 1)."""
    from dal3d_tpu_torch.ops import gather as tg

    rng = np.random.RandomState(Cin + Cout + len(kind))
    B, N = 1, 4000
    if kind == "one_chunk":
        K, M, shares, cps = 1, 32, 1, 1
        hit = rng.rand(B, K, M) < 0.7
    elif kind == "long_tap":
        K, M, shares, cps = 2, 20480, 4, 160
        hit = np.zeros((B, K, M), bool)
        hit[:, 0] = True
        hit[:, 1] = rng.rand(B, M) < 0.1
    else:
        n = int(kind[-1])
        K, M, shares, cps = 2, 32 * 40, 4, 10
        hit = np.zeros((B, K, M), bool)
        for s in range(shares):
            for c in range(n):
                first = (s * cps + 3 * c + 1) * 32
                hit[:, 0, first:first + 32] = rng.rand(B, 32) < 0.5
    idx = rng.randint(0, N, (B, K, M)).astype(np.int32)
    if kind == "long_tap":
        f = rng.rand(B, N, Cin).astype(np.float32)
        gg = rng.rand(B, M, Cout).astype(np.float32)
    else:
        f = rng.randn(B, N, Cin).astype(np.float32)
        gg = rng.randn(B, M, Cout).astype(np.float32)
    feats, g = t(f).to(cuda), t(gg).to(cuda)
    idx_t, hit_t = t(idx).to(cuda), t(hit).to(cuda)
    rb = torch.where(hit_t, idx_t, -1)
    got = _dw_direct(tg, feats, rb, g, shares, cps)
    torch.cuda.synchronize()
    ref = tg.gather_dw_plain(feats, idx_t, hit_t, g)
    scale = float(ref.abs().max())
    assert scale > 0
    assert float((got - ref).abs().max()) <= 1e-5 * scale
    for k in range(K):
        if not hit[:, k].any():
            assert float(got[k].abs().max()) == 0.0
    assert torch.equal(got, _dw_direct(tg, feats, rb, g, shares, cps))
    wrapped = tg.gather_dw(feats, idx_t, hit_t, g)
    assert float((wrapped - ref).abs().max()) <= 1e-5 * scale


def _encoder_like(dev, Cin, seed=0):
    """A level of sparse voxels (tests' clustered scenes on a (41, 64, 64)
    grid) with Cin features on ``dev``, its shared subm rulebook with the
    sorted symmetric plan, and its index grid."""
    from dal3d_tpu_torch.ops import sparse_backend as sp

    vf, vc, vv = small_voxels(seed, N=1500)
    rng = np.random.RandomState(seed + 1)
    f = np.where(vv[..., None], rng.randn(*vv.shape, Cin), 0.0).astype(np.float32)
    sb = sp.from_voxels(t(f).to(dev), t(vc).to(dev), t(vv).to(dev), (41, 64, 64))
    grid = sp.build_index_grid(sb)
    return sb, sp.with_plan(sp.subm_rulebook(sb, 3, grid)), grid


@pytest.mark.parametrize("kind,Cin,Cout", [("subm", 16, 16), ("subm", 32, 64), ("stem", 5, 16),
                                           ("down", 16, 32), ("conv_out", 64, 64),
                                           ("subm_unplanned", 16, 32)])
def test_gather_gemm_backward_on_card_matches_plain(cuda, kind, Cin, Cout):  # noqa: F811
    """The gradients of a subm conv (dX through K4 on the same sorted plan
    with the taps reversed), of the stem with a feature gradient (Cin 5: the
    dX launch's Cout 5 padded to a column tile and cut back), of strided
    convs (dX through K4 on the scatter-built inverse rulebook) and of a
    subm conv without a shared plan, against autograd through the plain
    version on the CPU: within 1e-5 of each gradient's scale, with one K4
    forward, one K4 dX and one dW launch."""
    from dal3d_tpu_torch.ops import gather as tg
    from dal3d_tpu_torch.ops import sparse_backend as sp

    out = {}
    for dev in ("cpu", cuda):
        sb, rb, grid = _encoder_like(dev, Cin)
        rng = np.random.RandomState(Cin + Cout)
        K = 3 if kind == "conv_out" else 27
        w = t((rng.randn(K, Cin, Cout) * 0.1).astype(np.float32)).to(dev).requires_grad_(True)
        x = sb.features.clone().requires_grad_(True)
        sbx = sb.replace(features=x)
        launches = (tg.gather_gemm.launches, tg.gather_dw.launches)
        if kind in ("subm", "stem"):
            y = sp.subm_conv(sbx, w, rb).features
        elif kind == "subm_unplanned":
            y = sp.subm_conv(sbx, w, rb[:2]).features
        elif kind == "down":
            y = sp.sparse_conv_downsample(sbx, w, 3, 2, 1, 1000, grid).features
        else:
            y = sp.sparse_conv_downsample(sbx, w, (3, 1, 1), (2, 1, 1), 0, 1500, grid).features
        gy = t(rng.randn(*y.shape).astype(np.float32)).to(dev)
        (y * gy).sum().backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            assert tg.gather_gemm.launches - launches[0] == 2
            assert tg.gather_dw.launches - launches[1] == 1
        out[str(dev)] = (y.detach().cpu(), x.grad.cpu(), w.grad.cpu())
    for a, b in zip(out["cpu"], out[str(cuda)]):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())
    assert float(out["cpu"][1].abs().max()) > 0 and float(out["cpu"][2].abs().max()) > 0


@pytest.mark.parametrize("kind,Cin,Cout", [("subm", 16, 16), ("subm", 32, 64), ("stem", 5, 16),
                                           ("down", 16, 32), ("conv_out", 64, 64),
                                           ("subm_unplanned", 16, 32)])
def test_gather_gemm_bf16_backward_on_card_matches_plain(cuda, kind, Cin, Cout):  # noqa: F811
    """The f32 backward test above in bf16: one bf16 K4 forward, one bf16
    K4 dX and one bf16 K4-dW launch, bf16 gradients; the output and dW
    within one bf16 ulp of scale of autograd through the plain version on
    the CPU, dX within four (the plain version rounds a row's sum to bf16
    after each tap, the kernel once)."""
    from dal3d_tpu_torch.ops import gather as tg
    from dal3d_tpu_torch.ops import sparse_backend as sp

    out = {}
    for dev in ("cpu", cuda):
        sb, rb, grid = _encoder_like(dev, Cin)
        sb = sb.replace(features=sb.features.bfloat16())
        rng = np.random.RandomState(Cin + Cout)
        K = 3 if kind == "conv_out" else 27
        w = t((rng.randn(K, Cin, Cout) * 0.1).astype(np.float32)).to(dev, torch.bfloat16)
        w.requires_grad_(True)
        x = sb.features.clone().requires_grad_(True)
        sbx = sb.replace(features=x)
        launches = (tg.gather_gemm_bf16.launches, tg.gather_dw_bf16.launches)
        if kind in ("subm", "stem"):
            y = sp.subm_conv(sbx, w, rb).features
        elif kind == "subm_unplanned":
            y = sp.subm_conv(sbx, w, rb[:2]).features
        elif kind == "down":
            y = sp.sparse_conv_downsample(sbx, w, 3, 2, 1, 1000, grid).features
        else:
            y = sp.sparse_conv_downsample(sbx, w, (3, 1, 1), (2, 1, 1), 0, 1500, grid).features
        gy = t(rng.randn(*y.shape).astype(np.float32)).to(dev)
        (y.float() * gy).sum().backward()
        assert y.dtype == x.grad.dtype == w.grad.dtype == torch.bfloat16
        if dev != "cpu":
            torch.cuda.synchronize()
            assert tg.gather_gemm_bf16.launches - launches[0] == 2
            assert tg.gather_dw_bf16.launches - launches[1] == 1
        out[str(dev)] = (y.detach().cpu(), x.grad.cpu(), w.grad.cpu())
    for a, b, tol in zip(out["cpu"], out[str(cuda)], (1, 4, 1)):
        assert a.shape == b.shape
        assert _rel(b, a) <= tol * BF16_ULP
    assert float(out["cpu"][1].float().abs().max()) > 0


def test_cbgs_gather_bf16_predict_on_card_matches_cpu(cuda):  # noqa: F811
    """The small CBGS model on the gather engine in bf16 (seeded weights) on
    the card (bf16 K4 launches, 21 a predict, none of the f32 kernel)
    against the CPU (plain versions): the dense map within 5e-2 of scale
    (bf16 rounded in other orders through the backbone), as many
    detections."""
    from dal3d_tpu_torch.ops import gather as tg

    vf, vc, vv = small_voxels(0)
    batch = {"voxel_features": vf, "voxel_coords": vc, "voxel_valid": vv}
    out, maps = {}, {}
    cfg = small_gather_cfg()
    cfg["model"]["backbone"]["dtype"] = "bfloat16"
    for dev in ("cpu", "cuda"):
        bundle = build_detector(cfg, device=dev, seed=4)
        n0 = (tg.gather_gemm.launches, tg.gather_gemm_bf16.launches)
        out[dev] = {k: v.cpu() for k, v in make_predict_step(bundle)(batch).items()}
        if dev == "cuda":
            assert (tg.gather_gemm.launches - n0[0], tg.gather_gemm_bf16.launches - n0[1]) == (
                0, 21)
        with torch.inference_mode():
            maps[dev] = bundle.model(*(torch.from_numpy(a).to(dev) for a in (vf, vc, vv)))[
                "dense"].float().cpu()
    assert _rel(maps["cuda"], maps["cpu"]) <= 5e-2
    n = [int(out[d]["det_valid"].sum()) for d in ("cpu", "cuda")]
    assert n[0] > 0 and abs(n[0] - n[1]) <= max(2, n[0] // 20)


def test_gather_rows_backward_on_card_matches_plain(cuda):  # noqa: F811
    """The query gather's backward from the strided [B, H*W, C] view of an
    NCHW map with repeated rows (a pixel picked for two classes): the rows'
    gradients summed, within 1e-6 of scale of autograd through advanced
    indexing on the CPU."""
    from dal3d_tpu_torch.ops import gather as tg

    rng = np.random.RandomState(3)
    B, C, H, W, P = 2, 128, 20, 20, 200
    x = rng.randn(B, C, H, W).astype(np.float32)
    pix = rng.randint(0, H * W, (B, P))
    pix[:, 1::2] = pix[:, ::2]  # every pixel twice
    rows = (pix + np.arange(B)[:, None] * H * W).reshape(-1).astype(np.int32)
    g = rng.randn(B * P, C).astype(np.float32)
    grads = {}
    for dev in ("cpu", cuda):
        xt = t(x).to(dev).requires_grad_(True)
        flat = xt.permute(0, 2, 3, 1).reshape(B, H * W, C)
        before = tg.gather_rows.launches
        q = tg.gather_rows(flat, t(rows).to(dev))
        (q * t(g).to(dev)).sum().backward()
        if dev != "cpu":
            assert tg.gather_rows.launches == before + 1
        grads[str(dev)] = xt.grad.cpu()
    a, b = grads["cpu"], grads[str(cuda)]
    assert float((a - b).abs().max()) <= 1e-6 * float(a.abs().max())


@pytest.mark.parametrize("B,G,P,pad", [(2, 200, 200, 180), (3, 7, 30, 0), (2, 40, 12, 5),
                                       (1, 1, 1, 0), (2, 64, 300, 50)])
def test_lsa_kernel_matches_plain(cuda, B, G, P, pad):  # noqa: F811
    """The Hungarian kernel against the plain version on seeded tie-free
    costs, with the last ``pad`` rows at the loss's 1e6 padding: col4row
    equal; the total cost equal to scipy's within 1e-5 of its scale."""
    from scipy.optimize import linear_sum_assignment as scipy_lsa

    from dal3d_tpu_torch.ops import lsa as tl

    rng = np.random.RandomState(G * 1000 + P)
    cost = (rng.rand(B, G, P) * 2 - 0.5).astype(np.float32)
    if pad:
        cost[:, G - pad:] = 1e6
    before = tl.linear_sum_assignment.launches
    got = tl.linear_sum_assignment(t(cost).to(cuda))
    torch.cuda.synchronize()
    assert tl.linear_sum_assignment.launches == before + 1
    ref = tl.linear_sum_assignment_plain(t(cost))
    assert torch.equal(got.cpu(), ref)
    for b in range(B):
        c4r = got[b].cpu().numpy()
        m = c4r >= 0
        assert len(set(c4r[m].tolist())) == int(m.sum()) == min(G, P)
        r, c = scipy_lsa(cost[b].astype(np.float64))
        want = float(cost[b][r, c].sum(dtype=np.float64))
        have = float(cost[b][np.arange(G)[m], c4r[m]].sum(dtype=np.float64))
        assert abs(have - want) <= 1e-5 * max(abs(want), 1.0)


@pytest.mark.parametrize("B,G,P,pad,ints", [(2, 200, 200, 80, 4), (2, 200, 200, 0, 2),
                                            (1, 256, 256, 0, 0), (1, 256, 256, 56, 3),
                                            (3, 33, 95, 0, 1)])
def test_lsa_kernel_ties_and_global_rows(cuda, B, G, P, pad, ints):  # noqa: F811
    """The Hungarian kernel where its argmin's tie rule and its row source
    matter: integer costs in [0, ints] (many equal values, so the first
    least column must win as in the plain version; ints 0: seeded tie-free
    costs) at the loss's [2, 200, 200] (cost in shared memory) and at
    [1, 256, 256], whose cost does not fit shared memory (rows read from
    global memory by the same loop): col4row equal to the plain version's,
    the total cost equal to scipy's."""
    from scipy.optimize import linear_sum_assignment as scipy_lsa

    from dal3d_tpu_torch.ops import lsa as tl

    rng = np.random.RandomState(G * 10 + P + ints)
    if ints:
        cost = rng.randint(0, ints + 1, (B, G, P)).astype(np.float32)
    else:
        cost = (rng.rand(B, G, P) * 2 - 0.5).astype(np.float32)
    if pad:
        cost[:, G - pad:] = 1e6
    before = tl.linear_sum_assignment.launches
    got = tl.linear_sum_assignment(t(cost).to(cuda))
    torch.cuda.synchronize()
    assert tl.linear_sum_assignment.launches == before + 1
    assert torch.equal(got.cpu(), tl.linear_sum_assignment_plain(t(cost)))
    for b in range(B):
        c4r = got[b].cpu().numpy()
        assert len(set(c4r.tolist())) == G and c4r.min() >= 0
        r, c = scipy_lsa(cost[b].astype(np.float64))
        want = float(cost[b][r, c].sum(dtype=np.float64))
        have = float(cost[b][np.arange(G), c4r].sum(dtype=np.float64))
        assert abs(have - want) <= 1e-5 * max(abs(want), 1.0)


def test_lsa_kernel_refuses_more_columns_than_a_warp_holds(cuda):  # noqa: F811
    """More than 1023 columns (32 lanes of at most 32) raise before any
    launch, either way round."""
    from dal3d_tpu_torch.ops import lsa as tl

    before = tl.linear_sum_assignment.launches
    for shape in ((1, 3, 1100), (1, 1100, 3)):
        with pytest.raises(ValueError, match="columns"):
            tl.linear_sum_assignment(torch.rand(*shape, device=cuda))
    assert tl.linear_sum_assignment.launches == before


def test_bev_pool_on_card_matches_cpu(cuda):  # noqa: F811
    """The camera branch's splat (plain PyTorch, float atomics on the card):
    the card's map within 1e-6 of the CPU's on the same coordinates, invalid
    points dropped whatever their rows hold."""
    from dal3d_tpu_torch.ops.bev_pool import bev_pool_batched

    rng = np.random.RandomState(0)
    B, Np, C, nx, ny, nz = 2, 200000, 16, 90, 80, 2
    feats = torch.from_numpy(rng.randn(B, Np, C).astype(np.float32))
    coords = torch.from_numpy(np.stack([rng.randint(-3, nx + 3, (B, Np)),
                                        rng.randint(-3, ny + 3, (B, Np)),
                                        rng.randint(-1, nz + 1, (B, Np))], -1).astype(np.int32))
    valid = ((coords >= 0) & (coords < torch.tensor([nx, ny, nz], dtype=torch.int32))).all(-1)
    feats[~valid] = float("nan")
    ref = bev_pool_batched(feats, coords, valid, nx, ny, nz)
    got = bev_pool_batched(feats.cuda(), coords.cuda(), valid.cuda(), nx, ny, nz).cpu()
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


def test_camera_branch_on_card_matches_cpu(cuda):  # noqa: F811
    """A narrow Swin, the LSS FPN and DepthLSSTransform (seeded weights) on
    the card against the CPU, f32, on one geometry: within 1e-4 of scale."""
    from unittest import mock

    from dal3d_tpu_torch.models.bevfusion import vtransforms as tvt
    from dal3d_tpu_torch.models.bevfusion.lss_fpn import GeneralizedLSSFPN
    from dal3d_tpu_torch.models.bevfusion.swin import SwinTransformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    swin = SwinTransformer(embed_dim=24, depths=(2, 2, 2, 2), num_heads=(1, 2, 2, 4))
    neck = GeneralizedLSSFPN(swin.out_channels, 32, 1)
    vt = tvt.DepthLSSTransform(32, 16, (64, 96), xbound=(-20.0, 20.0, 0.4),
                               ybound=(-20.0, 20.0, 0.4))
    mods = [m.eval() for m in (swin, neck, vt)]
    with torch.no_grad():
        for m in mods:
            for p in m.parameters():
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    imgs = torch.randn(2, 3, 64, 96, 3, generator=gen)
    depth = torch.rand(2, 3, 64, 96, 1, generator=gen) * 20
    eye = torch.eye(3).expand(2, 3, 3, 3).contiguous()
    base = torch.tensor([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    args = [base.expand(2, 3, 3, 3).contiguous(), torch.zeros(2, 3, 3),
            torch.tensor([[50.0, 0, 48], [0, 50, 32], [0, 0, 1]]).expand(2, 3, 3, 3).contiguous(),
            eye, torch.zeros(2, 3, 3)]
    fr = torch.from_numpy(tvt.create_frustum((64, 96), (8, 12), tvt.DBOUND)).permute(1, 2, 0, 3)
    geom = tvt.get_geometry(fr, *args)

    def run(dev):
        ms = [m.to(dev) for m in mods]
        f = ms[1](ms[0](imgs.to(dev).reshape(6, 64, 96, 3)))[0]
        return ms[2](f.reshape(2, 3, *f.shape[1:]), depth.to(dev),
                     *[a.to(dev) for a in args]).cpu()

    with mock.patch.object(tvt, "get_geometry", lambda frustum, *a: geom.to(frustum.device)), \
            torch.no_grad():
        ref, got = run("cpu"), run("cuda")
    assert tuple(got.shape) == (2, 50, 50, 16)
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_seg_and_center_heads_on_card_match_cpu(cuda):  # noqa: F811
    """BEVFusion's map-segmentation and CenterPoint heads (seeded weights,
    eval mode, f32) on the card against the CPU: the logits within 1e-5 of
    scale; the decode of the CPU's logits on the card equal to the CPU's
    (classes, validity) with boxes and scores within 1e-6; the centre loss
    within 1e-5 relative."""
    from dal3d_tpu_torch.models.bevfusion import centerpoint as tcp
    from dal3d_tpu_torch.models.bevfusion.segm import BEVSegmentationHead, bev_segmentation_loss
    from dal3d_tpu_torch.models.builder import init_random_

    torch.backends.cudnn.allow_tf32 = False
    heads = [init_random_(m, torch.Generator().manual_seed(1)).eval()
             for m in (tcp.CenterHead(32, (1, 2)), BEVSegmentationHead(32))]
    x = torch.randn(2, 24, 24, 32, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ref = [heads[0](x), heads[1](x)]
        got = [heads[0].to(cuda)(x.to(cuda)), heads[1].to(cuda)(x.to(cuda))]
    pairs = [(g[k], r[k]) for g, r in zip(got[0], ref[0]) for k in r] + [(got[1], ref[1])]
    for g, r in pairs:
        assert float((g.cpu() - r).abs().max()) <= 1e-5 * float(r.abs().max())
    cfg = tcp.CenterTestCfg(pc_range=(-9.6, -9.6), max_per_task=30, score_threshold=0.3)
    dec_cpu = tcp.center_head_decode(ref[0], cfg)
    dec_gpu = tcp.center_head_decode([{k: v.to(cuda) for k, v in p.items()} for p in ref[0]], cfg)
    for k in ("label_preds", "det_valid"):
        assert torch.equal(dec_gpu[k].cpu(), dec_cpu[k]), k
    for k in ("scores", "box3d_lidar"):
        assert torch.allclose(dec_gpu[k].cpu(), dec_cpu[k], rtol=1e-6, atol=1e-6), k
    gt = [torch.rand(2, 4, 9, generator=torch.Generator().manual_seed(t)) * 8 - 4 for t in (3, 4)]
    cls = [torch.tensor([[1, 1, 0, 0], [1, 0, 0, 0]]), torch.tensor([[1, 2, 2, 0], [2, 0, 0, 0]])]
    lc = tcp.center_head_loss(ref[0], gt, cls, cfg)["loss"]
    lg = tcp.center_head_loss([{k: v.to(cuda) for k, v in p.items()} for p in ref[0]],
                              [g.to(cuda) for g in gt], [c.to(cuda) for c in cls], cfg)["loss"]
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))
    tgt = (torch.rand(2, 24, 24, 6, generator=torch.Generator().manual_seed(5)) < 0.3).float()
    sc = bev_segmentation_loss(ref[1], tgt)["loss"]
    sg = bev_segmentation_loss(ref[1].to(cuda), tgt.to(cuda))["loss"]
    assert abs(float(sg) - float(sc)) <= 1e-5 * abs(float(sc))


def test_cbgs_gather_predict_on_card_matches_cpu(cuda):  # noqa: F811
    """The CBGS FPNVoxelNet on the gather engine (the small config, seeded
    weights, f32) on the card (K4 launches) against the CPU (plain
    versions): the dense map within 1e-4 of scale, detections equal as sets
    with boxes and scores within 1e-4."""
    from dal3d_tpu_torch.ops import gather as tg

    vf, vc, vv = small_voxels(0)
    batch = {"voxel_features": vf, "voxel_coords": vc, "voxel_valid": vv}
    out, maps = {}, {}
    for dev in ("cpu", "cuda"):
        bundle = build_detector(small_gather_cfg(), device=dev, seed=4)
        assert bundle.model.backbone.impl == "gather"
        n0 = tg.gather_gemm.launches
        out[dev] = {k: v.cpu() for k, v in make_predict_step(bundle)(batch).items()}
        if dev == "cuda":
            assert tg.gather_gemm.launches - n0 == 21  # 17 subm + 4 strided convs
        with torch.inference_mode():
            maps[dev] = bundle.model(*(torch.from_numpy(a).to(dev) for a in (vf, vc, vv)))[
                "dense"].cpu()
    assert float((maps["cuda"] - maps["cpu"]).abs().max()) <= 1e-4 * float(
        maps["cpu"].abs().max())
    for b in range(2):
        cv, gv = out["cpu"]["det_valid"][b], out["cuda"]["det_valid"][b]
        assert int(cv.sum()) == int(gv.sum()) > 0
        cs_, gs = out["cpu"]["scores"][b][cv], out["cuda"]["scores"][b][gv]
        co, go = torch.argsort(-cs_, stable=True), torch.argsort(-gs, stable=True)
        assert torch.allclose(gs[go], cs_[co], rtol=1e-4, atol=1e-5)
        assert torch.equal(out["cuda"]["label_preds"][b][gv][go],
                           out["cpu"]["label_preds"][b][cv][co])
        assert torch.allclose(out["cuda"]["box3d_lidar"][b][gv][go],
                              out["cpu"]["box3d_lidar"][b][cv][co], rtol=1e-4, atol=1e-4)


class _Spy:
    """Records every call of a module's kernel wrapper (``name``) with its
    arguments, and still runs it."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def spy(*args):
            self.calls.append(args)
            return self.orig(*args)

        # a wrapper counts its launches on the module attribute it is looked up by
        spy.launches = getattr(self.orig, "launches", 0)
        self.spy = spy
        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        if hasattr(self.orig, "launches"):
            self.orig.launches = self.spy.launches
        setattr(self.module, self.name, self.orig)


def _engine_cfg(impl):
    cfg = small_cfg("bfloat16" if impl == "brick" else "float32")
    bb = cfg["model"]["backbone"]
    bb.update(impl=impl, brick_caps=(600, 1200, 600, 200, 100),
              voxel_caps=(4000, 4000, 4000, 4000))
    return cfg


@pytest.mark.parametrize("impl", ["brick", "hybrid"])
def test_engine_launches_on_card_match_plain(cuda, impl):  # noqa: F811
    """Every kernel launch of the brick engine (K1 forward and input
    gradients, K3 weight gradients; bf16) and of the hybrid engine's L0 (K4
    forward and input gradients; f32) in a predict-mode forward and a
    train-mode forward + backward at small size, each against its plain
    version on the same inputs; the launch counts of the path."""
    from dal3d_tpu_torch.ops import gather as tg

    vf, vc, vv = small_voxels(0)
    model = build_detector(_engine_cfg(impl), device=cuda, seed=4).model
    args = [torch.from_numpy(a).to(cuda) for a in (vf, vc, vv)]
    if impl == "brick":
        spies = (_Spy(tbd, "banded_conv"), _Spy(tbd, "banded_dw"))
    else:
        spies = (_Spy(tg, "_launch_gemm"), _Spy(tg, "_launch_dw"))
    with spies[0] as fwd, spies[1] as dw:
        with torch.inference_mode():
            model.eval()(*args)
        n_predict = len(fwd.calls)
        out = model.train()(*args)
        (out["dense"] * torch.randn_like(out["dense"])).sum().backward()
        torch.cuda.synchronize()
    n_train, n_dw = len(fwd.calls) - n_predict, len(dw.calls)
    if impl == "brick":
        assert (n_predict, n_train, n_dw) == (42, 42 + 36, 21)
        for table, idx, w in fwd.calls:
            ref = tbd.banded_conv_plain(table, idx, w).float()
            got = tbd.banded_conv(table, idx, w).float()
            assert float((got - ref).abs().max()) <= 2.0 ** -7 * float(ref.abs().max())
        for table, idx, g in dw.calls:
            ref = tbd.banded_dw_plain(table, idx, g)
            assert float((tbd.banded_dw(table, idx, g) - ref).abs().max()) <= \
                1e-4 * float(ref.abs().max())
    else:  # L0: stem, 4 subm convs, the downsample; dX for all but the stem
        assert (n_predict, n_train, n_dw) == (6, 6 + 5, 6)
        with torch.no_grad():  # a launch walks its plan's rows in plan.order
            for f, plan, w in fwd.calls:  # forward and input-gradient launches
                rb = plan.rulebook
                ref = tg.gather_gemm_plain(f, torch.clamp(rb, min=0), rb >= 0, w)
                if plan.order is not None:
                    ref = torch.empty_like(ref).scatter_(
                        1, plan.order[..., None].expand_as(ref), ref)
                got = tg._launch_gemm(f, plan, w)
                assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
            for f, plan, g in dw.calls:
                rb, gp = plan.rulebook, g
                if plan.order is not None:
                    gp = torch.gather(g, 1, plan.order[..., None].expand_as(g))
                ref = tg.gather_dw_plain(f, torch.clamp(rb, min=0), rb >= 0, gp)
                got = tg._launch_dw(f, plan, g)
                assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("impl", ["brick", "hybrid", "dense"])
def test_engine_predict_on_card_matches_cpu(cuda, impl):  # noqa: F811
    """The small CBGS model on each new engine, seeded weights: the card
    (kernels, cuDNN) against the CPU (plain versions): the dense map within
    1e-4 of scale (f32) or 2e-2 (brick's bf16), detections equal as sets."""
    vf, vc, vv = small_voxels(0)
    batch = {"voxel_features": vf, "voxel_coords": vc, "voxel_valid": vv}
    out, maps = {}, {}
    for dev in ("cpu", "cuda"):
        bundle = build_detector(_engine_cfg(impl), device=dev, seed=4)
        out[dev] = {k: v.cpu() for k, v in make_predict_step(bundle)(batch).items()}
        with torch.inference_mode():
            maps[dev] = bundle.model(*(torch.from_numpy(a).to(dev) for a in (vf, vc, vv)))[
                "dense"].cpu()
    tol = 2e-2 if impl == "brick" else 1e-4
    assert float((maps["cuda"] - maps["cpu"]).abs().max()) <= tol * float(
        maps["cpu"].abs().max())
    for b in range(2):
        cv, gv = out["cpu"]["det_valid"][b], out["cuda"]["det_valid"][b]
        assert int(cv.sum()) > 0
        if impl != "brick":  # bf16 scores may reorder ties at the threshold
            assert int(cv.sum()) == int(gv.sum())
            cs_, gs = out["cpu"]["scores"][b][cv], out["cuda"]["scores"][b][gv]
            co, go = torch.argsort(-cs_, stable=True), torch.argsort(-gs, stable=True)
            assert torch.allclose(gs[go], cs_[co], rtol=1e-4, atol=1e-5)
            assert torch.allclose(out["cuda"]["box3d_lidar"][b][gv][go],
                                  out["cpu"]["box3d_lidar"][b][cv][co], rtol=1e-4, atol=1e-4)


def test_data_parallel_step_on_card(cuda, tmp_path, monkeypatch):  # noqa: F811
    """The small CBGS train step (banded engine, f32) on the card: (a) in a
    world of 1 on NCCL started by ``init_dist`` from torchrun's variables,
    bit-equal to the step with no group where the no-group step repeats bit
    for bit (else within twice the repeat's gap); (b) in a world of 2 gloo
    processes on this card, each rank on 2 rows of a 4-frame batch, against
    the no-group step on the 4 frames within twice the gap one ulp on the
    voxel features opens (tests/torch_dist_worker.py::check_step_floor: on
    the card rounding alone moves this step's gradient by percents, as
    phase 10 of chip_smoke.py shows; a world of 2 with one frame a rank
    strayed 1.6e-2 of the norm from the CPU's step while the no-group card
    step stayed within 2.8e-5, at a one-ulp floor of 2e-5)."""
    import socket

    import torch.distributed as dist

    import torch_dist_worker as w
    from dal3d_tpu_torch.parallel.dist import init_dist

    ref = w.cbgs_step(0, 1, "banded", device="cuda")
    again = w.cbgs_step(0, 1, "banded", device="cuda")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    try:
        assert init_dist("nccl") == (0, 1) and dist.get_backend() == "nccl"
        one = w.cbgs_step(0, 1, "banded", device="cuda")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if w.same_step(ref, again):
        assert w.same_step(one, ref)
    else:
        for n, g in ref["grads"].items():
            assert np.abs(one["grads"][n] - g).max() <= 2 * np.abs(again["grads"][n] - g).max()
    ref4 = w.cbgs_step(0, 1, "banded", device="cuda", frames=4)
    nudged = w.cbgs_step(0, 1, "banded", device="cuda", frames=4, nudge=1e-7)
    ranks = w.join_world(w.start_world(2, str(tmp_path / "world"), [
        ("step", "cbgs_step", {"impl": "banded", "device": "cuda", "frames": 4})]), timeout=300)
    for r in ranks:
        print(w.check_step_floor(w.result(r, "step"), ref4, nudged))


@pytest.mark.skipif(torch.cuda.device_count() < 2, reason="needs two or more cards")
def test_data_parallel_step_over_cards(cuda, tmp_path):  # noqa: F811
    """The small CBGS train step in an NCCL world of one rank a card (up to
    4), each rank on its rows of a 4-frame batch, against one process on
    the 4 frames, within tests/torch_dist_worker.py::check_step_floor's
    tolerances."""
    import torch_dist_worker as w

    n = min(4, torch.cuda.device_count())
    ref = w.cbgs_step(0, 1, "banded", device="cuda", frames=4)
    nudged = w.cbgs_step(0, 1, "banded", device="cuda", frames=4, nudge=1e-7)
    ranks = w.join_world(w.start_world(n, str(tmp_path / "world"), [
        ("step", "cbgs_step", {"impl": "banded", "device": "cuda", "frames": 4})],
        backend="nccl"), timeout=300)
    for r in ranks:
        print(w.check_step_floor(w.result(r, "step"), ref, nudged))
