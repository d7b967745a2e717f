"""The block structure of the banded weights that the forward kernel's skip
relies on (csrc/banded_conv.cu walks only the 32 x 64 blocks of each w[q]
that hold a nonzero).

The full-width CBGS backbone (configs/cbgs_spatial_temporal.py) is built on
the CPU without running a forward; every launch of a predict gets its weight
from the port's own functions (``_pad_wband_np``, ``_halo_band``,
``down_wband``) over random layer weights, and every dual gather of a train
step the transposed weight ``_BandedConv.backward`` hands the kernel. Per
launch type, the count of nonzero blocks of each tap is held to the count
derived here from the brick geometry alone: a change of the band layout that
loses the sparsity shows on the CPU."""
import functools
import os

import numpy as np
import pytest
import torch

from dal3d_tpu_torch.models.backbones.scn import FPNSpMiddleResNetFHD
from dal3d_tpu_torch.models.builder import grid_size
from dal3d_tpu_torch.ops import banded as bd
from dal3d_tpu_torch.ops import sparse_brick as spb
from dal3d_tpu_torch.utils.config import Config

BK, BN = bd.BAND_BLOCK
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _backbone():
    cfg = Config.fromfile(os.path.join(ROOT, "configs", "cbgs_spatial_temporal.py"))
    nx, ny, nz = grid_size(cfg["voxel_generator"])
    bcfg = cfg["model"]["backbone"]
    return FPNSpMiddleResNetFHD((nz + 1, ny, nx), int(bcfg["num_input_features"]),
                                brick_widths=tuple(bcfg["brick_widths"]))


def _launches():
    """[(type, w [Q, R, Rout], nonzero (row, col) pairs of each tap from the
    geometry)] of the forward launches of one predict, in order, and the
    types whose call gets a dual gather in a train step."""
    net = _backbone()
    rng = np.random.RandomState(0)
    out, duals = [], set()

    def rand(weight):
        return torch.from_numpy(rng.randn(*weight.shape).astype(np.float32))

    def pad(tag, bw, C, valid):
        w = torch.from_numpy(spb._pad_wband_np(bw, C, with_valid=valid))
        Cv = C + (1 if valid else 0)
        feat = [[((bw - 1) * C + c, c) for c in range(C)],
                [(r, r + C) for r in range(bw * C)],
                [(c, (bw + 1) * C + c) for c in range(C)]]
        if valid:  # validity columns after the features, the same shifts
            fi, fo = bw * C, (bw + 2) * C
            feat[0].append((fi + bw - 1, fo))
            feat[1] += [(fi + v, fo + 1 + v) for v in range(bw)]
            feat[2].append((fi, fo + bw + 1))
        assert w.shape[1:] == (bw * Cv, spb._pad8((bw + 2) * Cv))
        out.append((tag + " pad", w, feat))

    def subm(tag, bw, conv):
        Cin, Cout = conv.weight.shape[1:]
        R2p = spb._pad8((bw + 2) * Cin)
        w = spb._halo_band(9, 3, bw, rand(conv.weight))
        w = torch.nn.functional.pad(w, (0, 0, 0, R2p - w.shape[1]))
        # output voxel p reads halo-padded voxels p..p+2
        nz = [(r, p * Cout + o) for p in range(bw) for r in range(p * Cin, (p + 3) * Cin)
              for o in range(Cout)]
        out.append((tag + " subm" if tag != "stem" else "stem conv", w, [nz] * 9))

    def down(tag, bw, shape, mod):
        (Do, Ho, Wo), meta = spb.downsample_static_meta(shape, bw, mod.kernel_size, mod.stride,
                                                        mod.padding, mod.out_bw)
        Cin, Cout = mod.weight.shape[1:]
        R2p = spb._pad8((bw + 2) * (Cin + 1))
        w = spb.down_wband(rand(mod.weight), bw, mod.out_bw, meta, R2p)
        kw, sw, pw = meta["kw"], meta["sw"], meta["pw"]
        b0h, nwb_h = meta["b0h"], meta["nwb_h"]
        taps = []
        for jb in range(nwb_h):
            nz = []
            for dw in range(kw):
                for p in range(mod.out_bw):
                    # input voxel of output voxel p and w-tap dw, and the
                    # halo-padded brick that covers it
                    r = sw * p - pw + dw
                    cover = min(max((r - b0h * bw) // bw, 0), nwb_h - 1)
                    if cover != jb:
                        continue
                    col = r - (b0h + jb) * bw + 1
                    nz += [(col * Cin + i, p * Cout + o) for i in range(Cin) for o in range(Cout)]
                    nz.append(((bw + 2) * Cin + col, mod.out_bw * Cout + p))
            taps.append(nz)
        out.append((tag + " conv", w, taps * (meta["kd"] * meta["kh"])))
        return (Do, Ho, Wo)

    shape, ws = net.sparse_shape, net.widths
    pad("stem", ws[0], net.l0.stem.weight.shape[1], False)
    subm("stem", ws[0], net.l0.stem)
    levels = [("L0", net.l0), ("L1", net.stage1), ("L2", net.stage2), ("L3", net.stage3)]
    for n, (tag, level) in enumerate(levels):
        bw = ws[n]
        for block in (level.block0, level.block1):
            for conv in (block.conv1, block.conv2):
                pad(tag, bw, conv.weight.shape[1], False)
                subm(tag, bw, conv)
                duals.update({tag + " pad", tag + " subm"})
        ds = f"ds{n + 1}"
        pad(ds, bw, level.down.weight.shape[1], True)
        duals.add(ds + " pad")
        shape = down(ds, bw, shape, level.down)
    return out, duals


# the launch types of a predict, and those whose calls get a dual gather in a
# train step (not the stem's two, whose table has no gradient, and not the
# strided convs, whose rulebook is not tap-symmetric)
TYPES = ["stem pad", "stem conv"] + [f"{t} {k}" for n in range(4)
                                     for t, k in ((f"L{n}", "pad"), (f"L{n}", "subm"),
                                                  (f"ds{n + 1}", "pad"), (f"ds{n + 1}", "conv"))]
DUAL_TYPES = [t for t in TYPES if t.endswith("subm") or (t.endswith("pad") and t != "stem pad")]


@functools.lru_cache(maxsize=1)
def launches():
    return _launches()


def _blocks(nz, transpose=False):
    """Count of distinct BK x BN blocks that the (row, col) pairs touch."""
    return len({((c if transpose else r) // BK, (r if transpose else c) // BN) for r, c in nz})


def test_launches_of_a_predict_and_a_train_step():
    """42 forward launches with the shapes of the main path (the kernel
    widths chip_smoke.py captures), 36 of them with a dual gather."""
    out, duals = launches()
    assert len(out) == 42 and [tag for tag, _, _ in out[:2]] == TYPES[:2]
    assert sorted({tag for tag, _, _ in out}) == sorted(TYPES)
    assert duals == set(DUAL_TYPES) and sum(tag in duals for tag, _, _ in out) == 36
    shapes = {tag: tuple(w.shape) for tag, w, _ in out}
    assert shapes == {
        "stem pad": (3, 80, 96), "stem conv": (9, 96, 256),
        "L0 pad": (3, 256, 288), "L0 subm": (9, 288, 256),
        "ds1 pad": (3, 272, 312), "ds1 conv": (18, 312, 528),
        "L1 pad": (3, 512, 576), "L1 subm": (9, 576, 512),
        "ds2 pad": (3, 528, 600), "ds2 conv": (9, 600, 520),
        "L2 pad": (3, 512, 640), "L2 subm": (9, 640, 512),
        "ds3 pad": (3, 520, 656), "ds3 conv": (9, 656, 520),
        "L3 pad": (3, 512, 768), "L3 subm": (9, 768, 512),
        "ds4 pad": (3, 516, 776), "ds4 conv": (3, 776, 520)}


@pytest.mark.parametrize("tag,dual", [(t, False) for t in TYPES] + [(t, True) for t in DUAL_TYPES],
                         ids=[t.replace(" ", "_") for t in TYPES]
                         + [t.replace(" ", "_") + "_dual" for t in DUAL_TYPES])
def test_nonzero_blocks_per_tap(tag, dual):
    """Every tap's nonzero 32 x 64 blocks are exactly those of its geometry
    (random layer weights: every entry the geometry allows is nonzero), for
    the forward weight and for the dual gather's flipped, transposed one."""
    w, taps = next((w, taps) for tag_, w, taps in launches()[0] if tag_ == tag)
    if dual:
        w, taps = w.flip(0).transpose(1, 2).contiguous(), taps[::-1]
    mask = bd.band_block_mask(w)
    assert mask.sum(dim=(1, 2)).tolist() == [_blocks(nz, transpose=dual) for nz in taps]
    # the skip is worth having: most blocks of every weight are zero
    assert int(mask.sum()) <= 0.75 * mask.numel()
