"""Swin Transformer (Tiny) camera backbone (port of
``dal3d_tpu/models/bevfusion/swin.py``).

Swin-T by default: embed 96, depths (2, 2, 6, 2), heads (3, 6, 12, 24),
window 7, outputs of stages (1, 2, 3). NHWC in and out. The arithmetic
follows the JAX module, not the reference's torch Swin where they differ:
- each stage pads its input to window multiples once, before its blocks,
  and crops after them (the reference pads per block); the shifted-window
  mask is built from the padded size with a -100 fill;
- ``PatchMerging`` pads odd sizes and concatenates each 2x2 group row-major
  ((0, 0), (0, 1), (1, 0), (1, 1)); ``convert_swin.py`` permutes the
  reference's column-major weights to match;
- the MLP's GELU is the tanh approximation and every LayerNorm has eps 1e-6
  (flax's defaults);
- window attention is matmul + relative position bias + mask + softmax, the
  same math as JAX's einsums;
- stochastic depth (``DropPath``, rates ``linspace(0, 0.2, 12)`` over the
  blocks) drops a whole residual branch per image in train mode only, from
  the ``generator`` attribute the train step sets
  (``runtime/bevfusion_steps.py::dropout_generator``).

Parameter names follow the microsoft / timm Swin (``patch_embed.proj``,
``layers.{i}.blocks.{j}.attn.qkv``, ``layers.{i}.downsample.reduction``,
``norm{i}``): ``layers[i].downsample`` is JAX's ``PatchMerging_{i}``, run
after stage i's blocks and output norm, before stage i + 1.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6  # flax nn.LayerNorm's default


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] (H, W multiples of ws) -> [B * nW, ws * ws, C]."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(windows: torch.Tensor, ws: int, B: int, H: int, W: int) -> torch.Tensor:
    C = windows.shape[-1]
    x = windows.reshape(B, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def relative_position_index(ws: int) -> np.ndarray:
    """[ws * ws, ws * ws] index into the (2 ws - 1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shift_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """[nW, ws * ws, ws * ws] additive mask of the shifted windows over a
    padded H x W map: -100 between tokens that came from different regions
    of the roll, else 0."""
    img = np.zeros((1, H, W, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    mw = img.reshape(1, H // ws, ws, W // ws, ws, 1).transpose(0, 1, 3, 2, 4, 5).reshape(
        -1, ws * ws)
    return np.where(mw[:, None, :] != mw[:, :, None], -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7):
        super().__init__()
        self.num_heads, self.ws = num_heads, window_size
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(relative_position_index(window_size)).long(),
                             persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [nW, L, C]; mask [nW_img, L, L] (added to every image's windows)."""
        nW, L, C = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(nW, L, 3, h, C // h).permute(2, 0, 3, 1, 4)  # [3, nW, h, L, d]
        out = self.core(qkv[0], qkv[1], qkv[2], mask)
        return self.proj(out.transpose(1, 2).reshape(nW, L, C))

    def bias(self) -> torch.Tensor:
        """[h, L, L] relative position bias."""
        L = self.ws * self.ws
        b = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        return b.reshape(L, L, self.num_heads).permute(2, 0, 1)

    def core(self, q, k, v, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """softmax(q k^T / sqrt(d) + bias (+ mask)) v over [nW, h, L, d]."""
        nW, h, L, d = q.shape
        attn = torch.matmul(q * d ** -0.5, k.transpose(-2, -1)) + self.bias()[None]
        if mask is not None:
            n_img = mask.shape[0]
            attn = (attn.reshape(-1, n_img, h, L, L) + mask[None, :, None]).reshape(nW, h, L, L)
        return torch.matmul(torch.softmax(attn, dim=-1), v)


class DropPath(nn.Module):
    """Stochastic depth: in train mode, zero the whole residual branch of an
    image with probability ``rate`` and scale the kept ones by 1 / (1 -
    rate); the masks come from ``self.generator`` (set by the train step;
    None draws from the device's default generator)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        mask = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1), generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift: int = 0,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0):
        super().__init__()
        self.ws, self.shift = window_size, shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self._masks = {}

    def _mask(self, H: int, W: int, device) -> torch.Tensor:
        key = (H, W, str(device))
        if key not in self._masks:  # outside inference mode: train steps reuse it
            with torch.inference_mode(False):
                self._masks[key] = torch.from_numpy(
                    shift_mask(H, W, self.ws, self.shift)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        ws, s = self.ws, self.shift
        y = self.norm1(x)
        mask = None
        if s > 0:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
            mask = self._mask(H, W, x.device)
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, B, H, W)
        if s > 0:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + self.drop_path(y)
        return x + self.drop_path(self.mlp(self.norm2(x)))


class PatchMerging(nn.Module):
    """2x2 neighbourhoods (odd sizes padded) concatenated row-major -> 4C ->
    LayerNorm -> bias-free linear to 2C."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
        return self.reduction(self.norm(x.reshape(B, H // 2, W // 2, 4 * C)))


class PatchEmbed(nn.Module):
    """Conv patch_size x patch_size at stride patch_size with flax's "SAME"
    padding, then LayerNorm; NHWC out."""

    def __init__(self, embed_dim: int, patch_size: int):
        super().__init__()
        self.patch = patch_size
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch
        H, W = x.shape[1:3]
        ph = max((-(-H // p) - 1) * p + p - H, 0)
        pw = max((-(-W // p) - 1) * p + p - W, 0)
        x = x.permute(0, 3, 1, 2)
        if ph or pw:
            x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        return self.norm(self.proj(x).permute(0, 2, 3, 1))


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 drop_paths: Sequence[float], downsample: bool):
        super().__init__()
        self.ws = window_size
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size, 0 if d % 2 == 0 else window_size // 2,
                      drop_path=float(drop_paths[d])) for d in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The blocks on x padded to window multiples, cropped back."""
        H, W = x.shape[1:3]
        ws = self.ws
        xp = F.pad(x, (0, 0, 0, (-W) % ws, 0, (-H) % ws))
        for blk in self.blocks:
            xp = blk(xp)
        return xp[:, :H, :W]


class SwinTransformer(nn.Module):
    """Swin-T by default; returns the NHWC maps of the ``out_indices``
    stages, each after its LayerNorm."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 out_indices: Sequence[int] = (1, 2, 3), patch_size: int = 4,
                 drop_path_rate: float = 0.2):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.patch_embed = PatchEmbed(embed_dim, patch_size)
        dpr = np.linspace(0.0, drop_path_rate, sum(depths))
        self.layers = nn.ModuleList()
        for i, depth in enumerate(depths):
            first = sum(depths[:i])
            self.layers.append(SwinStage(embed_dim * 2 ** i, depth, num_heads[i], window_size,
                                         dpr[first:first + depth], i < len(depths) - 1))
        for i in self.out_indices:
            self.add_module(f"norm{i}", nn.LayerNorm(embed_dim * 2 ** i, eps=LN_EPS))

    @property
    def out_channels(self):
        return [self.layers[i].blocks[0].norm1.normalized_shape[0] for i in self.out_indices]

    def forward(self, x: torch.Tensor):
        """x [N, H, W, 3] -> list of [N, H / 2^(i+2), W / 2^(i+2), C_i]."""
        x = self.patch_embed(x)
        outs = []
        for i, layer in enumerate(self.layers):
            if i > 0:
                x = self.layers[i - 1].downsample(x)
            x = layer(x)
            if i in self.out_indices:
                outs.append(getattr(self, f"norm{i}")(x))
        return outs
