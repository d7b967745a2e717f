"""Brick-packed sparse 3D convolution engine, the banded and the brick form
(port of ``dal3d_tpu/ops/sparse_brick.py``).

Data model (the JAX layout, kept at every public function):
  features  [B, Mb, bw*C]   w-major rows (view [B, Mb, bw, C])
  brick_lin [B, Mb] int32   brick cell (z*H + y)*(W/bw) + x/bw; padding rows
                            carry the sentinel D*H*(W/bw)
  vmask     [B, Mb, bw]     per-voxel active mask

The banded engine (``spatial=True``) compacts bricks in y-major spatial
order ((y, x_brick, z) ascending); capacity overflow drops the highest
(y, x, z) bricks. The brick engine (``spatial=False``) compacts them in
the order of their last appearance in the candidate list (``_compact_cells``:
each cell's representative is its last entry, as JAX's scatter keeps the
last writer); beyond the cap the latest-appearing bricks are dropped. Every
plan (brick pack, subm rulebook, halo rows, downsample output set and
rulebook) is built on the tensor's device with the same scatter / cumsum
steps as JAX, so the integer plans are bit-identical. Both engines run the
same convs: JAX's non-banded subm conv (halo pad, gather, one einsum) and
strided conv are the functions ``banded_gather_matmul`` computes over the
full rulebook.

Rulebooks are full: one int32 tensor with -1 for a miss. A subm rulebook is
JAX's ``pack_host_rulebook`` layout [B, 11, Mb]: rows 0-8 the (dz, dy) taps in
z-major order, rows 9/10 the left/right w-neighbour bricks (halo rows). Every
conv runs as ``banded_gather_matmul`` over such a rulebook; there are no band
plans (see ops/banded.py).

Gradients: plans and rulebooks are integer tensors built outside the graph
(``torch.no_grad``); the einsums that spread a layer weight over its banded
block weights are differentiable; the halo-pad selection weights are
constants. Each call tells ``banded_gather_matmul`` whether its rulebook is
tap-symmetric: the subm conv and every halo-pad rulebook are, the strided
conv's (M != Mb) is not.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .banded import _pad8, banded_gather_matmul


def _triple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v, v)


@dataclass
class BrickBatch:
    features: torch.Tensor  # [B, Mb, bw*C]
    brick_lin: torch.Tensor  # [B, Mb] int32, sentinel-padded
    vmask: torch.Tensor  # [B, Mb, bw] bool
    shape: Tuple[int, int, int]  # voxel (D, H, W)
    bw: int

    @property
    def wb(self) -> int:
        return self.shape[2] // self.bw

    @property
    def num_cells(self) -> int:
        D, H, _ = self.shape
        return D * H * self.wb

    @property
    def channels(self) -> int:
        return self.features.shape[-1] // self.bw

    def feat4(self) -> torch.Tensor:
        """[B, Mb, bw, C] view (for per-channel ops like BN)."""
        B, Mb, _ = self.features.shape
        return self.features.reshape(B, Mb, self.bw, self.channels)

    def active_sites(self) -> torch.Tensor:
        """[N, 4] int64 (b, z, y, x) of the active voxels."""
        _, H, _ = self.shape
        Wb = self.wb
        b, m, s = torch.nonzero(self.vmask & (self.brick_lin < self.num_cells)[..., None],
                                as_tuple=True)
        cell = self.brick_lin[b, m].long()
        return torch.stack([b, cell // (H * Wb), cell // Wb % H, cell % Wb * self.bw + s], 1)

    def replace(self, **kw) -> "BrickBatch":
        return dataclasses.replace(self, **kw)


def _decode(cell, H, Wb):
    z = torch.div(cell, H * Wb, rounding_mode="floor")
    rem = cell - z * (H * Wb)
    y = torch.div(rem, Wb, rounding_mode="floor")
    return z, y, rem - y * Wb


def _grid_from_lin(brick_lin: torch.Tensor, nbc: int) -> torch.Tensor:
    """[B, nbc+1] int32 brick cell -> row index (-1 = inactive)."""
    B, Mb = brick_lin.shape
    lin = brick_lin.long()
    rows = torch.arange(Mb, device=lin.device, dtype=torch.int32).expand(B, Mb)
    grid = torch.full((B, nbc + 1), -1, dtype=torch.int32, device=lin.device)
    grid.scatter_(1, torch.clamp(lin, max=nbc),
                  torch.where(lin < nbc, rows, torch.full_like(rows, -1)))
    grid[:, nbc] = -1
    return grid


@torch.no_grad()
def build_brick_grid(bb: BrickBatch) -> torch.Tensor:
    """[B, nbc+1] int32 brick-cell -> row index."""
    return _grid_from_lin(bb.brick_lin, bb.num_cells)


def _grid_lookup(grid: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
    """grid [B, nbc+1], cells [B, ...] (nbc = miss) -> rows [B, ...] int32."""
    B = grid.shape[0]
    return torch.gather(grid, 1, cells.reshape(B, -1).long()).reshape(cells.shape)


def _neighbor_lookup(brick_lin, grid, deltas, shape_bricks) -> torch.Tensor:
    """Rows [B, Q, Mb] (-1 = miss) of the bricks at cell offsets ``deltas``
    [Q, 3] (dz, dy, dwb)."""
    D, H, Wb = shape_bricks
    nbc = D * H * Wb
    lin = brick_lin.long()
    z, y, wb = _decode(lin, H, Wb)
    d = torch.as_tensor(np.asarray(deltas), dtype=torch.long, device=lin.device)
    qz = z[:, None, :] + d[None, :, 0:1]
    qy = y[:, None, :] + d[None, :, 1:2]
    qw = wb[:, None, :] + d[None, :, 2:3]
    inb = ((qz >= 0) & (qz < D) & (qy >= 0) & (qy < H) & (qw >= 0) & (qw < Wb)
           & (lin < nbc)[:, None, :])
    qcell = torch.where(inb, (qz * H + qy) * Wb + qw, torch.full_like(qz, nbc))
    return _grid_lookup(grid, qcell)


@torch.no_grad()
def halo_indices(bb: BrickBatch, grid: torch.Tensor | None = None) -> torch.Tensor:
    """[B, 2, Mb] rows of the left/right w-neighbour bricks (-1 = miss)."""
    if grid is None:
        grid = build_brick_grid(bb)
    return _neighbor_lookup(bb.brick_lin, grid, [[0, 0, -1], [0, 0, 1]],
                            (bb.shape[0], bb.shape[1], bb.wb))


@torch.no_grad()
def subm_rulebook(bb: BrickBatch, kernel_size=3,
                  grid: torch.Tensor | None = None) -> torch.Tensor:
    """[B, 11, Mb] int32 subm rulebook: the 9 (dz, dy) taps (w-taps live in
    the halo-padded row), then the 2 halo rows; -1 = miss."""
    kd, kh, _ = _triple(kernel_size)
    if grid is None:
        grid = build_brick_grid(bb)
    dzs = np.arange(kd) - (kd - 1) // 2
    dys = np.arange(kh) - (kh - 1) // 2
    deltas = np.stack(np.meshgrid(dzs, dys, np.zeros(1, np.int64), indexing="ij"),
                      -1).reshape(-1, 3)
    idx = _neighbor_lookup(bb.brick_lin, grid, deltas, (bb.shape[0], bb.shape[1], bb.wb))
    return torch.cat([idx, halo_indices(bb, grid)], dim=1)


def _pad_rulebook(halo: torch.Tensor) -> torch.Tensor:
    """[B, 3, Mb] rulebook of the halo-pad gather: [left, self, right]."""
    B, _, Mb = halo.shape
    self_idx = torch.arange(Mb, dtype=halo.dtype, device=halo.device).expand(B, 1, Mb)
    return torch.cat([halo[:, :1], self_idx, halo[:, 1:2]], dim=1)


@dataclass
class BandedSubmRulebook:
    """The two full rulebooks every SubM conv of one level shares (the
    counterpart of JAX's pair of BandPlans)."""

    conv: torch.Tensor  # [B, kd*kh, Mb] (dz, dy) taps over the halo-padded table
    pad: torch.Tensor  # [B, 3, Mb] [left, self, right] rows of the halo-pad gather


@torch.no_grad()
def subm_rulebook_banded(bb: BrickBatch, kernel_size=3,
                         grid: torch.Tensor | None = None) -> BandedSubmRulebook:
    rb = subm_rulebook(bb, kernel_size, grid)
    return BandedSubmRulebook(conv=rb[:, :-2].contiguous(), pad=_pad_rulebook(rb[:, -2:]))


def _pad_wband_np(bw: int, C: int, with_valid: bool) -> np.ndarray:
    """[3, R_in, pad8(R_out)] selection weights of the halo-pad gather (taps
    left, self, right). R_in = bw*C (+bw validity columns), output layout
    (bw+2)*C features (then bw+2 validity), zero-padded to a multiple of 8."""
    Cv = C + (1 if with_valid else 0)
    r_in = bw * Cv
    r_out = (bw + 2) * Cv
    W = np.zeros((3, r_in, _pad8(r_out)), np.float32)
    for c in range(C):
        W[0, (bw - 1) * C + c, c] = 1.0  # left halo <- left brick's last column
        W[2, c, (bw + 1) * C + c] = 1.0  # right halo <- right brick's first column
        for w in range(bw):
            W[1, w * C + c, (w + 1) * C + c] = 1.0
    if with_valid:
        fb_in, fb_out = bw * C, (bw + 2) * C
        W[0, fb_in + bw - 1, fb_out] = 1.0
        W[2, fb_in, fb_out + bw + 1] = 1.0
        for w in range(bw):
            W[1, fb_in + w, fb_out + 1 + w] = 1.0
    return W


def _halo_band(Kzy: int, kw: int, bw: int, weights: torch.Tensor) -> torch.Tensor:
    """[Kzy, (bw+2)*Cin, bw*Cout] banded weights for halo-padded rows: padded
    column j holds input voxel w = j-1; output column p with w-tap dw reads
    padded column p + dw - hw + 1."""
    Cin, Cout = weights.shape[-2], weights.shape[-1]
    hw = (kw - 1) // 2
    if hw > 1:
        raise ValueError(f"halo formulation supports kw <= 3, got {kw}")
    S = np.zeros((kw, bw + 2, bw), np.float32)
    for dw in range(kw):
        for p in range(bw):
            S[dw, p + dw - hw + 1, p] = 1.0
    wk = weights.reshape(Kzy, kw, Cin, Cout)
    St = torch.as_tensor(S, dtype=weights.dtype, device=weights.device)
    band = torch.einsum("dwp,kdio->kwipo", St, wk)
    return band.reshape(Kzy, (bw + 2) * Cin, bw * Cout)


def subm_conv(bb: BrickBatch, weights: torch.Tensor, rulebook: BandedSubmRulebook,
              kernel_size=3) -> BrickBatch:
    """Submanifold sparse conv on the banded engine (``_subm_conv_banded``):
    a 3-tap halo-pad gather, then the kd*kh-tap conv gather, each one
    ``banded_gather_matmul``. weights [kd*kh*kw, Cin, Cout] z-major."""
    kd, kh, kw = _triple(kernel_size)
    bw, C = bb.bw, bb.channels
    Cout = weights.shape[-1]
    dt = bb.features.dtype
    pad_w = torch.as_tensor(_pad_wband_np(bw, C, with_valid=False), dtype=dt,
                            device=bb.features.device)
    padded = banded_gather_matmul(bb.features, pad_w, rulebook.pad, symmetric=True)
    band_w = _halo_band(kd * kh, kw, bw, weights)  # [Kzy, (bw+2)C, bw*Cout]
    R2p = padded.shape[-1]
    if band_w.shape[1] != R2p:
        band_w = torch.nn.functional.pad(band_w, (0, 0, 0, R2p - band_w.shape[1]))
    out = banded_gather_matmul(padded, band_w, rulebook.conv, symmetric=True)
    out = out.to(dt) * bb.vmask.repeat_interleave(Cout, dim=-1).to(dt)
    return bb.replace(features=out)


def _out_dim(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def downsample_static_meta(shape, bw: int, kernel_size, stride, padding,
                           out_bw: int):
    """Shape-only part of downsample_plan: (out_shape, meta)."""
    kd, kh, kw = _triple(kernel_size)
    sd, sh, sw = _triple(stride)
    pd, ph, pw = _triple(padding)
    D, H, W = (int(s) for s in shape)
    Do, Ho, Wo = _out_dim(D, kd, sd, pd), _out_dim(H, kh, sh, ph), _out_dim(W, kw, sw, pw)
    if Wo % out_bw or (sw * out_bw) % bw or pw > 1:
        raise ValueError(f"downsample: W_out={Wo}, out_bw={out_bw}, bw={bw}, "
                         f"stride_w={sw}, padding_w={pw} unsupported")
    w_start, w_end = -pw, sw * (out_bw - 1) - pw + kw - 1
    # halo-padded brick b spans voxels [b*bw - 1, b*bw + bw]
    b0h = (w_start + 1) // bw
    nwb_h = max(1, -(-(w_end - b0h * bw) // bw))
    meta = dict(kd=kd, kh=kh, kw=kw, sw=sw, pw=pw, b0h=b0h, nwb_h=nwb_h)
    return (Do, Ho, Wo), meta


def _rank_first(occ: torch.Tensor, cap: int, fill: int) -> torch.Tensor:
    """occ [B, K] 0/1 over keys in ascending order -> [B, cap] the first cap
    occupied keys (``fill`` past the last), via the same cumsum rank and slot
    scatter as JAX's ``_rank_grid`` compaction."""
    B, K = occ.shape
    # one scan over the flattened rows (a device-wide scan: a scan along a
    # long innermost dim runs one block per row), then each row's offset off
    csum = torch.cumsum(occ.reshape(-1), dim=0).view(B, K)
    before = torch.cat([csum.new_zeros(1), csum[:-1, -1]])
    pos = csum - before[:, None] - 1
    tgt = torch.where(occ > 0, torch.clamp(pos, max=cap), torch.full_like(pos, cap))
    keys = torch.arange(K, device=occ.device, dtype=torch.long).expand(B, K)
    out = torch.full((B, cap + 1), fill, dtype=torch.long, device=occ.device)
    # unoccupied keys all land in the dropped slot cap; occupied ones are unique
    out.scatter_(1, tgt, torch.where(occ > 0, keys, torch.full_like(keys, fill)))
    return out[:, :cap]


def _spatial_outputs(grid, bb: BrickBatch, kzy, out_bricks, A: int, b0e: int, nwbe: int,
                     out_cap: int) -> torch.Tensor:
    """The banded engine's output bricks [B, out_cap]: the input occupancy
    OR-ed over each output's window (strided slices of the padded grid),
    ranked in y-major (y, x_brick, z) order; overflow drops the highest."""
    kd, kh, sd, sh, pd, ph = kzy
    Do, Ho, Wbo = out_bricks
    D, H, _ = bb.shape
    Wb = bb.wb
    B = grid.shape[0]
    pz0 = max(0, pd)
    pz1 = max(0, sd * (Do - 1) - pd + kd - 1 - (D - 1))
    py0 = max(0, ph)
    py1 = max(0, sh * (Ho - 1) - ph + kh - 1 - (H - 1))
    pw0 = max(0, -b0e)
    pw1 = max(0, A * (Wbo - 1) + b0e + nwbe - 1 - (Wb - 1))
    occ = (grid[:, :bb.num_cells] >= 0).reshape(B, D, H, Wb)
    occ = torch.nn.functional.pad(occ.to(torch.uint8), (pw0, pw1, py0, py1, pz0, pz1))
    acc = torch.zeros(B, Do, Ho, Wbo, dtype=torch.uint8, device=grid.device)
    for dz in range(kd):
        for dy in range(kh):
            for dwb in range(nwbe):
                z0, y0, x0 = pz0 - pd + dz, py0 - ph + dy, pw0 + b0e + dwb
                acc |= occ[:, z0:z0 + sd * (Do - 1) + 1:sd,
                           y0:y0 + sh * (Ho - 1) + 1:sh,
                           x0:x0 + A * (Wbo - 1) + 1:A]
    occ_y = acc.permute(0, 2, 3, 1).reshape(B, -1).long()  # (yo, wbo, zo) key order
    oky = _rank_first(occ_y, out_cap, -1)
    zz = torch.remainder(oky, Do)
    rr = torch.div(oky, Do, rounding_mode="floor")
    return torch.where(
        oky >= 0,
        (zz * Ho + torch.div(rr, Wbo, rounding_mode="floor")) * Wbo + torch.remainder(rr, Wbo),
        torch.full_like(oky, Do * Ho * Wbo))


def _compact_cells(cells: torch.Tensor, nbc: int, cap: int) -> torch.Tensor:
    """Dedup + compact cell lists [B, L] (sentinel nbc) to [B, cap] in the
    order of each cell's last entry in the list (JAX's ``_compact_cells``:
    its scatter keeps the last writer, here a deterministic ``amax`` of the
    entry positions); beyond ``cap`` the latest ones are dropped."""
    B, L = cells.shape
    c = torch.clamp(cells.long(), max=nbc)
    pos = torch.arange(L, device=cells.device).expand(B, L)
    last = torch.full((B, nbc + 1), -1, dtype=torch.long, device=cells.device)
    last.scatter_reduce_(1, c, pos, reduce="amax")
    win = (torch.gather(last, 1, c) == pos) & (c < nbc)
    slot = torch.cumsum(win.long(), dim=-1) - 1
    tgt = torch.where(win, torch.clamp(slot, max=cap), cap)
    out = torch.full((B, cap + 1), nbc, dtype=torch.long, device=cells.device)
    out.scatter_(1, tgt, torch.where(win, c, nbc))  # winners hold distinct slots
    return out[:, :cap]


@torch.no_grad()
def downsample_plan(bb: BrickBatch, kernel_size, stride, padding, out_bw: int,
                    out_cap: int, grid: torch.Tensor | None = None, spatial: bool = True):
    """Plan a strided sparse conv in brick space. ``spatial``: JAX's dense-
    stencil form, output bricks in y-major order (the banded engine);
    otherwise each input brick's candidate outputs, compacted in order of
    appearance (the brick engine). Returns (out_lin [B, Mo] int32, idx
    [B, Q, Mo] int32 with -1 = miss, out_shape, meta, halo [B, 2, Mb])."""
    kd, kh, kw = _triple(kernel_size)
    sd, sh, sw = _triple(stride)
    pd, ph, pw = _triple(padding)
    D, H, W = bb.shape
    bw, Wb = bb.bw, bb.wb
    (Do, Ho, Wo), meta = downsample_static_meta(bb.shape, bw, kernel_size, stride,
                                                padding, out_bw)
    A = (sw * out_bw) // bw  # input-brick advance per output brick
    b0h, nwb_h = meta["b0h"], meta["nwb_h"]
    Wbo = Wo // out_bw
    nbc_out = Do * Ho * Wbo
    nbc_in = bb.num_cells
    B = bb.brick_lin.shape[0]
    dev = bb.brick_lin.device
    if grid is None:
        grid = build_brick_grid(bb)

    # output active bricks: those whose window (the w window extended one
    # output voxel each side, so that an output brick exists wherever its
    # halo voxel is active) holds an active input brick
    w_start_e, w_end_e = -sw - pw, sw * out_bw - pw + kw - 1
    b0e = w_start_e // bw
    nwbe = (w_end_e // bw) - b0e + 1
    if spatial:
        out_lin = _spatial_outputs(grid, bb, (kd, kh, sd, sh, pd, ph), (Do, Ho, Wbo), A, b0e,
                                   nwbe, out_cap)
    else:
        # invert the window per input brick (each feeds at most ceil(k / s)
        # outputs a dim), candidate-major as JAX's list, then compact
        cand = torch.as_tensor(np.stack(np.meshgrid(
            np.arange(-(-kd // sd)), np.arange(-(-kh // sh)), np.arange(-(-nwbe // A)),
            indexing="ij"), -1).reshape(-1, 3), dtype=torch.long, device=dev)
        lin = bb.brick_lin.long()
        zi, yi, wi = (v[:, None, :] for v in _decode(lin, H, Wb))
        zo = torch.div(zi + pd, sd, rounding_mode="floor") - cand[None, :, 0:1]
        yo = torch.div(yi + ph, sh, rounding_mode="floor") - cand[None, :, 1:2]
        wo = torch.div(wi - b0e, A, rounding_mode="floor") - cand[None, :, 2:3]
        ok = ((zo >= 0) & (zo < Do) & (sd * zo - pd <= zi) & (zi <= sd * zo - pd + kd - 1)
              & (yo >= 0) & (yo < Ho) & (sh * yo - ph <= yi) & (yi <= sh * yo - ph + kh - 1)
              & (wo >= 0) & (wo < Wbo) & (A * wo + b0e <= wi) & (wi <= A * wo + b0e + nwbe - 1)
              & (lin < nbc_in)[:, None, :])
        cells = torch.where(ok, (zo * Ho + yo) * Wbo + wo, nbc_out)
        out_lin = _compact_cells(cells.reshape(B, -1), nbc_out, out_cap)

    # rulebook: taps over (dz, dy, halo-padded input brick), z-major
    taps = torch.as_tensor(
        np.stack(np.meshgrid(np.arange(kd), np.arange(kh), np.arange(nwb_h),
                             indexing="ij"), -1).reshape(-1, 3),
        dtype=torch.long, device=dev)
    zo, yo, wbo = _decode(out_lin, Ho, Wbo)
    zi = sd * zo[:, None, :] - pd + taps[None, :, 0:1]
    yi = sh * yo[:, None, :] - ph + taps[None, :, 1:2]
    wi = A * wbo[:, None, :] + b0h + taps[None, :, 2:3]
    inb = ((zi >= 0) & (zi < D) & (yi >= 0) & (yi < H) & (wi >= 0) & (wi < Wb)
           & (out_lin < nbc_out)[:, None, :])
    qcell = torch.where(inb, (zi * H + yi) * Wb + wi, torch.full_like(zi, nbc_in))
    idx = _grid_lookup(grid, qcell)
    return (out_lin.to(torch.int32), idx, (Do, Ho, Wo), meta, halo_indices(bb, grid))


def _down_tap(sw: int, pw: int, dw: int, p: int, b0h: int, nwb_h: int, bw: int):
    """(jb, col): covering halo-padded brick + padded column of input voxel
    r = sw*p - pw + dw."""
    r = sw * p - pw + dw
    jb = min(max((r - b0h * bw) // bw, 0), nwb_h - 1)
    col = r - (b0h + jb) * bw + 1
    assert 0 <= col <= bw + 1, (r, jb, col)
    return jb, col


def down_wband(weights: torch.Tensor, bw: int, out_bw: int, meta: dict,
               R2p: int) -> torch.Tensor:
    """[kd*kh*nwb_h, R2p, pad8(out_bw*Cout + out_bw)] block weights of the
    strided conv's tap gather over the halo-padded [features | validity]
    rows (R2p wide): per (dz, dy, covering brick) tap, output voxel p takes
    the padded column of input voxel sw*p - pw + dw for each w-tap dw, and
    counts that column's validity. weights [kd*kh*kw, Cin, Cout] z-major."""
    kd, kh, kw, sw, pw = meta["kd"], meta["kh"], meta["kw"], meta["sw"], meta["pw"]
    b0h, nwb_h = meta["b0h"], meta["nwb_h"]
    Kzy = kd * kh
    Cin, Cout = weights.shape[-2], weights.shape[-1]
    dev = weights.device
    R2 = (bw + 2) * (Cin + 1)
    Routt = out_bw * Cout + out_bw
    S = np.zeros((kw, nwb_h, bw + 2, out_bw), np.float32)
    for dw in range(kw):
        for p in range(out_bw):
            jb, col = _down_tap(sw, pw, dw, p, b0h, nwb_h, bw)
            S[dw, jb, col, p] = 1.0
    wk = weights.reshape(Kzy, kw, Cin, Cout)
    band_f = torch.einsum("djwp,kdio->kjwipo",
                          torch.as_tensor(S, dtype=weights.dtype, device=dev), wk)
    band_f = band_f.reshape(Kzy, nwb_h, (bw + 2) * Cin, out_bw * Cout)
    bv = torch.as_tensor(S.sum(0), dtype=weights.dtype, device=dev)
    wq = torch.zeros(Kzy, nwb_h, R2p, _pad8(Routt), dtype=weights.dtype, device=dev)
    wq[:, :, :(bw + 2) * Cin, :out_bw * Cout] = band_f
    wq[:, :, (bw + 2) * Cin:R2, out_bw * Cout:Routt] = bv
    return wq.reshape(Kzy * nwb_h, R2p, -1)


def downsample_conv_banded(bb: BrickBatch, weights: torch.Tensor, kernel_size, stride,
                           padding, out_bw: int, out_cap: int, plan=None,
                           grid: torch.Tensor | None = None, spatial: bool = True) -> BrickBatch:
    """Strided sparse conv on the banded engine (``downsample_conv_banded``),
    or with ``spatial=False`` on the brick engine (JAX's ``downsample_conv``,
    the same function over a first-appearance plan): a 3-tap halo-pad
    gather of the combined [features | validity] table, then one Q =
    kd*kh*nwb_h tap gather whose block weights yield [conv output |
    per-voxel validity count]. weights [kd*kh*kw, Cin, Cout] z-major."""
    if plan is None:
        plan = downsample_plan(bb, kernel_size, stride, padding, out_bw, out_cap, grid,
                               spatial)
    out_lin, idx, out_shape, meta, halo = plan
    bw, C = bb.bw, bb.channels
    Cout = weights.shape[-1]
    dt = bb.features.dtype
    dev = bb.features.device

    rows_v = torch.cat([bb.features, bb.vmask.to(dt)], dim=-1)
    pad_w = torch.as_tensor(_pad_wband_np(bw, C, with_valid=True), dtype=dt, device=dev)
    padded = banded_gather_matmul(rows_v, pad_w, _pad_rulebook(halo),
                                  symmetric=True)  # [B, Mb, R2p]

    Routt = out_bw * Cout + out_bw
    wq = down_wband(weights, bw, out_bw, meta, padded.shape[-1])
    out_all = banded_gather_matmul(padded, wq, idx, symmetric=False)

    out = out_all[..., :out_bw * Cout]
    out_v = out_all[..., out_bw * Cout:Routt]
    Do, Ho, Wo = out_shape
    nbc_out = Do * Ho * (Wo // out_bw)
    vmask_out = (out_v.float() > 0.5) & (out_lin < nbc_out)[..., None]
    out = out.to(dt) * vmask_out.repeat_interleave(Cout, dim=-1).to(dt)
    return BrickBatch(features=out, brick_lin=out_lin, vmask=vmask_out,
                      shape=out_shape, bw=out_bw)


def _brick_candidates(coords_zyx: torch.Tensor, valid: torch.Tensor, shape, bw: int):
    """Candidate brick cells (with the halo dilation) of a voxel list:
    (cand [B, 2N], cell [B, N], wpos [B, N], nbc, Wb)."""
    D, H, W = (int(s) for s in shape)
    if W % bw:
        raise ValueError(f"W={W} not divisible by brick width {bw}")
    Wb = W // bw
    nbc = D * H * Wb
    c = coords_zyx.long()
    z, y, x = c[..., 0], c[..., 1], c[..., 2]
    xb = torch.div(x, bw, rounding_mode="floor")
    cell = torch.where(valid, (z * H + y) * Wb + xb, torch.full_like(z, nbc))
    wpos = x - xb * bw
    # a brick whose halo column holds an active voxel must exist (vmask-empty)
    # so the halo-padded gathers can read it; a voxel sits on at most one edge
    if bw >= 2:
        sent = torch.full_like(cell, nbc)
        dil = torch.where(valid & (wpos == 0) & (xb > 0), cell - 1,
                          torch.where(valid & (wpos == bw - 1) & (xb < Wb - 1),
                                      cell + 1, sent))
        cand = torch.cat([cell, dil], dim=-1)
    else:  # bw == 1: a voxel is both edges at once
        sent = torch.full_like(cell, nbc)
        dil_l = torch.where(valid & (xb > 0), cell - 1, sent)
        dil_r = torch.where(valid & (xb < Wb - 1), cell + 1, sent)
        cand = torch.cat([cell, dil_l, dil_r], dim=-1)
    return cand, cell, wpos, nbc, Wb


def _compact_cells_spatial(cells: torch.Tensor, nbc: int, cap: int,
                           shape_bricks: Tuple[int, int, int]) -> torch.Tensor:
    """Dedup + compact cell lists [B, N] (sentinel nbc) to [B, cap] in y-major
    order (y, x_brick, z); overflow drops the highest keys."""
    D, H, Wb = shape_bricks
    B = cells.shape[0]
    valid = cells < nbc
    z, y, wb = _decode(cells, H, Wb)
    ykey = torch.where(valid, (y * Wb + wb) * D + z, torch.full_like(cells, nbc))
    occ = torch.zeros(B, nbc + 1, dtype=torch.long, device=cells.device)
    occ.scatter_(1, ykey, torch.ones_like(ykey))
    keys = _rank_first(occ[:, :nbc], cap, nbc)  # ascending occupied y-major keys
    zk = torch.remainder(keys, D)
    r = torch.div(keys, D, rounding_mode="floor")
    yk = torch.div(r, Wb, rounding_mode="floor")
    lin = (zk * H + yk) * Wb + (r - yk * Wb)
    return torch.where(keys < nbc, lin, torch.full_like(lin, nbc))


@torch.no_grad()
def count_active_bricks(coords_zyx: torch.Tensor, valid: torch.Tensor, shape,
                        bw: int) -> torch.Tensor:
    """The true (uncapped) active-brick count [B] that ``from_voxels`` would
    need: compared against ``mb_cap`` it shows a silent truncation."""
    cand, _, _, nbc, _ = _brick_candidates(coords_zyx, valid.bool(), shape, bw)
    occ = torch.zeros(cand.shape[0], nbc + 1, dtype=torch.bool, device=cand.device)
    occ.scatter_(1, torch.clamp(cand, max=nbc), True)
    return occ[:, :nbc].sum(-1)


@torch.no_grad()
def pack_plan_arrays(coords_zyx: torch.Tensor, valid: torch.Tensor, shape, bw: int,
                     mb_cap: int, spatial: bool = True):
    """(brick_lin [B, Mb] int32, row [B, N] int32): the active bricks in
    y-major order (``spatial``) or in order of appearance, and each voxel's
    brick row (-1 = invalid or dropped)."""
    D, H, W = (int(s) for s in shape)
    cand, cell, _, nbc, Wb = _brick_candidates(coords_zyx, valid, shape, bw)
    lin = (_compact_cells_spatial(cand, nbc, mb_cap, (D, H, Wb)) if spatial
           else _compact_cells(cand, nbc, mb_cap))
    grid = _grid_from_lin(lin, nbc)
    row = _grid_lookup(grid, cell)
    row = torch.where(valid & (row >= 0), row, torch.full_like(row, -1))
    return lin.to(torch.int32), row


def from_voxels(features: torch.Tensor, coords_zyx: torch.Tensor, valid: torch.Tensor,
                shape, bw: int, mb_cap: int, spatial: bool = True) -> BrickBatch:
    """Voxel list (any row order) -> BrickBatch, bricks in y-major order
    (``spatial``, the banded engine) or in order of appearance (the brick
    engine: beyond ``mb_cap`` the latest-appearing bricks are dropped).
    features [B, N, C], coords_zyx [B, N, 3], valid [B, N]."""
    D, H, W = (int(s) for s in shape)
    B, N, C = features.shape
    valid = valid.bool()
    brick_lin, row = pack_plan_arrays(coords_zyx, valid, shape, bw, mb_cap, spatial)
    ok = row >= 0
    wpos = torch.remainder(coords_zyx[..., 2].long(), bw)
    fv = torch.cat([torch.where(ok[..., None], features, torch.zeros_like(features)),
                    ok[..., None].to(features.dtype)], dim=-1)  # [B, N, C+1]
    # scatter-add each voxel's (features, 1) into slot (row, wpos); dropped
    # voxels go to the extra row mb_cap, which is cut off
    flat = torch.where(ok, row.long(), torch.full_like(row.long(), mb_cap)) * bw + wpos
    buf = torch.zeros(B, (mb_cap + 1) * bw, C + 1, dtype=features.dtype,
                      device=features.device)
    buf.scatter_add_(1, flat[..., None].expand(B, N, C + 1), fv)
    buf = buf[:, :mb_cap * bw].reshape(B, mb_cap, bw, C + 1)
    return BrickBatch(features=buf[..., :C].reshape(B, mb_cap, bw * C),
                      brick_lin=brick_lin, vmask=buf[..., C] > 0, shape=(D, H, W), bw=bw)


def to_dense(bb: BrickBatch) -> torch.Tensor:
    """[B, H, W, C*D] BEV map with channel = c*D + d."""
    B, Mb, _ = bb.features.shape
    bw, C = bb.bw, bb.channels
    D, H, W = bb.shape
    Wb = bb.wb
    nbc = bb.num_cells
    feat = bb.features * bb.vmask.repeat_interleave(C, dim=-1).to(bb.features.dtype)
    lin = bb.brick_lin.long()
    dense = torch.zeros(B, nbc + 1, bw * C, dtype=feat.dtype, device=feat.device)
    dense.scatter_(1, torch.clamp(lin, max=nbc)[..., None].expand(B, Mb, bw * C),
                   torch.where((lin < nbc)[..., None], feat, torch.zeros_like(feat)))
    dense = dense[:, :nbc].reshape(B, D, H, Wb * bw, C)
    return dense.permute(0, 2, 3, 4, 1).reshape(B, H, W, C * D)
