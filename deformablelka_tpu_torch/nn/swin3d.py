"""The 3D shifted-window transformer of Swin UNETR, channels-last.

MONAI's `SwinTransformer` as `monai/networks/nets/swin_unetr.py` builds it
for Swin UNETR, on (B, D, H, W, C) maps:

- a 2³ stride-2 conv patch embedding with bias and no norm;
- four stages (`layers1` … `layers4`, MONAI's `BasicLayer`), each of
  `depth` blocks and a patch merging. In a stage, a 3D window of 7³ and a
  shift of 3 become, along each axis where the map is not larger than the
  window, the map's size and 0 (MONAI's `get_window_size`), and the map
  is padded with zeros to whole windows;
- a block: LayerNorm, zero padding, (odd blocks) a roll by −shift and the
  shift mask, window attention, the reverse, a roll by +shift, the crop;
  a residual; then LayerNorm, Linear → exact GELU → Linear (ratio 4), a
  residual;
- window attention: softmax(q·kᵀ/√d + B_rel + mask)·v per head, windows
  row-major over (d, h, w), B_rel read from a (13³, heads) table at the
  tokens' relative offset. A window clamped to a smaller map (n tokens)
  reads the first n rows and columns of the 7³ window's index, as MONAI
  does (`relative_position_index[:n, :n]`);
- the shift mask (`compute_mask`): the padded map cut into 27 regions by
  the slices (0:-ws, -ws:-shift, -shift:) of each axis, −100 between
  tokens of different regions;
- patch merging (MONAI's `PatchMergingV2`): the eight 2×2×2 neighbours in
  `itertools.product` order, LayerNorm(8C), a bias-free Linear 8C → 2C;
- every hidden state (the embedding, each stage's merged output) leaves
  through an affine-free LayerNorm (`proj_out`).

State-dict keys are MONAI's (`layers1.0.blocks.0.attn.qkv.weight`, …),
except that the index buffer `relative_position_index` is not persistent.
`remat=True` recomputes each block in the backward pass (MONAI's
`use_checkpoint`).

Spans (`profiling.span`): `dlka.swin.stage` around each stage's blocks
and merge (args: stage, padded grid, window, shift, windows), and
`dlka.swin.attention` around each block's roll, partition, attention,
reverse and roll back; the latter opens again when a block is recomputed.
Each attention adds its windows to the counter `dlka.swin.windows`
(`profiling.count`).
"""

from __future__ import annotations

import functools
import itertools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from deformablelka_tpu_torch import profiling
from deformablelka_tpu_torch.nn.layers import Conv3d, Linear
from deformablelka_tpu_torch.nn.norms import LayerNorm
from deformablelka_tpu_torch.profiling import span

MASKED = -100.0


def window_and_shift(size, window, shift):
    """Per axis (MONAI's `get_window_size`): the window and shift, or the
    map's size and 0 where the map is not larger than the window."""
    ws = tuple(s if s <= w else w for s, w in zip(size, window))
    sh = tuple(0 if s <= w else t for s, w, t in zip(size, window, shift))
    return ws, sh


def padded(size, ws):
    """`size` rounded up to whole windows."""
    return tuple(-(-s // w) * w for s, w in zip(size, ws))


def window_partition(x, ws):
    """(B, D, H, W, C) → (B·nW, ws₀·ws₁·ws₂, C), windows row-major."""
    B, D, H, W, C = x.shape
    x = x.view(B, D // ws[0], ws[0], H // ws[1], ws[1], W // ws[2], ws[2], C)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, math.prod(ws), C)


def window_reverse(wins, ws, B, D, H, W):
    x = wins.view(B, D // ws[0], H // ws[1], W // ws[2], ws[0], ws[1], ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, D, H, W, -1)


@functools.lru_cache(maxsize=None)
def relative_position_index(window) -> np.ndarray:
    """(n, n) index into the flattened (2w₀−1)(2w₁−1)(2w₂−1) table: the
    rank of the pair's offset (Δd, Δh, Δw), each shifted by w − 1."""
    coords = np.stack(np.meshgrid(*(np.arange(w) for w in window), indexing="ij"))
    rel = coords.reshape(3, -1)[:, :, None] - coords.reshape(3, -1)[:, None, :]
    rel += (np.array(window) - 1)[:, None, None]
    return ((rel[0] * (2 * window[1] - 1) + rel[1]) * (2 * window[2] - 1)
            + rel[2]).astype(np.int64)


def region_labels(dims, ws, shift, device=None) -> torch.Tensor:
    """(D, H, W) labels of the 27 regions of a padded map (MONAI's
    `compute_mask`): along each axis the slices 0:-ws, -ws:-shift and
    -shift: in turn; an axis without a shift is one region."""
    label = torch.zeros((), dtype=torch.int64, device=device)
    for a, (n, w, s) in enumerate(zip(dims, ws, shift)):
        i = torch.arange(n, device=device)
        r = (i >= n - w).long() + (i >= n - s).long() if s else torch.zeros_like(i)
        label = label * 3 + r.view([-1 if b == a else 1 for b in range(3)])
    return label


def shift_mask(dims, ws, shift, device=None) -> torch.Tensor:
    """(nW, n, n): −100 between tokens of a window that lie in different
    regions of the padded map, 0 elsewhere."""
    lab = window_partition(region_labels(dims, ws, shift, device)[None, ..., None], ws)[..., 0]
    return (lab[:, :, None] != lab[:, None, :]).float() * MASKED


class WindowAttention(nn.Module):
    """Multi-head self-attention within windows, with the relative-position
    bias of a `window` (the largest) window and an optional shift mask."""

    def __init__(self, dim: int, num_heads: int, window):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.empty(math.prod(2 * w - 1 for w in window), num_heads))
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(tuple(window))), persistent=False)
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.relative_position_bias_table.normal_(0.0, 0.02, generator=generator)

    def forward(self, x, mask=None):
        Bw, n, C = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).view(Bw, n, 3, h, C // h).permute(2, 0, 3, 1, 4)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[
            self.relative_position_index[:n, :n].reshape(-1)].view(n, n, h).permute(2, 0, 1)
        if mask is None:
            attn = attn + bias
        else:
            nw = mask.shape[0]
            attn = (attn.view(Bw // nw, nw, h, n, n) + (bias + mask[:, None])).view(Bw, h, n, n)
        out = torch.softmax(attn, -1) @ v
        return self.proj(out.transpose(1, 2).reshape(Bw, n, C))


class FusedLayerNorm(LayerNorm):
    """LayerNorm over the last axis through `F.layer_norm` (one kernel
    each way); `norms.LayerNorm` keeps the JAX package's order of
    operations, which this model, with no JAX counterpart, does not need."""

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.weight, self.bias, self.eps)


class Mlp(nn.Module):
    """MONAI's `MLPBlock`: linear1 → exact GELU → linear2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear1 = Linear(dim, hidden)
        self.linear2 = Linear(hidden, dim)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x)))


class SwinBlock3D(nn.Module):
    """Pre-norm (shifted) window attention and MLP on (B, D, H, W, C)."""

    def __init__(self, dim: int, num_heads: int, window, shift):
        super().__init__()
        self.window, self.shift = tuple(window), tuple(shift)
        self.norm1 = FusedLayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, self.window)
        self.norm2 = FusedLayerNorm(dim)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x, mask=None):
        B, D, H, W, C = x.shape
        ws, shift = window_and_shift((D, H, W), self.window, self.shift)
        Dp, Hp, Wp = padded((D, H, W), ws)
        y = F.pad(self.norm1(x), (0, 0, 0, Wp - W, 0, Hp - H, 0, Dp - D))
        rolled = any(shift)
        with span("dlka.swin.attention", shift=shift, windows=B * Dp * Hp * Wp // math.prod(ws)):
            if rolled:
                y = torch.roll(y, [-s for s in shift], (1, 2, 3))
            wins = window_partition(y, ws)
            profiling.count("dlka.swin.windows", wins.shape[0])
            y = window_reverse(self.attn(wins, mask if rolled else None), ws, B, Dp, Hp, Wp)
            if rolled:
                y = torch.roll(y, shift, (1, 2, 3))
        x = x + y[:, :D, :H, :W]
        return x + self.mlp(self.norm2(x))


class PatchMergingV2(nn.Module):
    """The eight 2×2×2 neighbours (odd sizes padded), LayerNorm(8C), a
    bias-free Linear 8C → 2C."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = FusedLayerNorm(8 * dim)
        self.reduction = Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x):
        _, D, H, W, _ = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2, 0, D % 2))
        x = torch.cat([x[:, i::2, j::2, k::2]
                       for i, j, k in itertools.product(range(2), repeat=3)], -1)
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    """MONAI's `BasicLayer`: `depth` blocks, the odd ones shifted by half
    the window, then the patch merging."""

    def __init__(self, dim: int, depth: int, num_heads: int, window, index: int,
                 remat: bool = False):
        super().__init__()
        self.window = tuple(window)
        self.half = tuple(w // 2 for w in window)
        self.index, self.remat = index, remat
        self.blocks = nn.ModuleList(
            SwinBlock3D(dim, num_heads, self.window, self.half if j % 2 else (0, 0, 0))
            for j in range(depth))
        self.downsample = PatchMergingV2(dim)

    def forward(self, x):
        B, D, H, W, _ = x.shape
        ws, shift = window_and_shift((D, H, W), self.window, self.half)
        dims = padded((D, H, W), ws)
        with span("dlka.swin.stage", stage=self.index, grid=dims, window=ws, shift=shift,
                  windows=B * math.prod(dims) // math.prod(ws)):
            mask = shift_mask(dims, ws, shift, x.device) if any(shift) else None
            for blk in self.blocks:
                if self.remat and torch.is_grad_enabled():
                    # no RNG state to keep: the forward draws no random numbers
                    x = checkpoint(blk, x, mask, use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    x = blk(x, mask)
            return self.downsample(x)


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, embed_dim: int, patch: int = 2):
        super().__init__()
        self.proj = Conv3d(in_channels, embed_dim, patch, stride=patch, padding=0)

    def forward(self, x):
        return self.proj(x)


def proj_out(x):
    """The affine-free LayerNorm over channels of each hidden state."""
    return F.layer_norm(x, (x.shape[-1],))


class SwinTransformer3D(nn.Module):
    """(B, D, H, W, Cin) → the five hidden states [embedding, stage 1 …
    stage 4 merged], each through `proj_out`."""

    def __init__(self, in_channels: int, embed_dim: int, depths, num_heads,
                 window, remat: bool = False):
        super().__init__()
        self.patch_embed = PatchEmbed(in_channels, embed_dim)
        self.n_stages = len(depths)
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            setattr(self, f"layers{i + 1}", nn.ModuleList(
                [SwinStage(embed_dim * 2 ** i, depth, heads, window, i, remat)]))

    def forward(self, x):
        x = self.patch_embed(x)
        hidden = [proj_out(x)]
        for i in range(self.n_stages):
            x = getattr(self, f"layers{i + 1}")[0](x)
            hidden.append(proj_out(x))
        return hidden
