"""Swin-UNet: the Swin-Transformer encoder-decoder U-Net.

Port of `deformablelka_tpu/models/swinunet.py` (upstream's
`2D/networks/swinunet.py`, SwinTransformerSys), channels-last, with
upstream's torch attribute names: a 4×4 patch embedding, 4 stages of Swin
blocks (7×7 window attention with a relative-position bias table,
alternate blocks cyclically shifted by 3 with the −100 block mask, MLP
ratio 4) with patch merging between them, a decoder of patch expansions,
concatenated skips mapped back by a linear layer, a final ×4 expansion and
a bias-free 1×1 head. `SwinBlock` and `PatchMerging` serve STViT and
HiFormer too.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from deformablelka_tpu_torch.models import maxvit
from deformablelka_tpu_torch.models.maxvit_dlka import FinalPatchExpand_X4, PatchExpand
from deformablelka_tpu_torch.nn.layers import Linear, PromotingConv2d
from deformablelka_tpu_torch.nn.norms import LayerNorm
from deformablelka_tpu_torch.nn.segformer import MLP_FFN, attend

# (ws², ws²) index into the (2ws − 1)² bias table
relative_position_index = maxvit._rel_index


def window_partition(x, ws):
    """(B, H, W, C) → (B·nW, ws², C), windows row-major."""
    return maxvit.window_partition(x, ws).flatten(1, 2)


def window_reverse(wins, ws, H, W):
    return maxvit.window_reverse(wins.unflatten(1, (ws, ws)), ws, H, W)


@functools.lru_cache(maxsize=None)
def shift_mask_np(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """The shifted windows' attention mask (nW, ws², ws²): −100 between
    pixels of different regions of the rolled map."""
    img = np.zeros((1, H, W, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    r1, r2 = H // ws, W // ws
    wins = img.reshape(r1, ws, r2, ws).transpose(0, 2, 1, 3).reshape(r1 * r2, ws * ws)
    diff = wins[:, :, None] - wins[:, None, :]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7):
        super().__init__()
        self.num_heads, self.window_size = num_heads, window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window_size - 1) ** 2, num_heads))
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(window_size).reshape(-1)), persistent=False)

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.relative_position_bias_table.normal_(0.0, 0.02, generator=generator)

    def forward(self, x, mask=None):
        Bw, N, C = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(Bw, N, 3, h, C // h).permute(2, 0, 3, 1, 4)
        bias = self.relative_position_bias_table[self.relative_position_index]
        bias = bias.reshape(N, N, h).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            bias = (bias[:, None] + mask[None, :, None]).expand(
                Bw // nw, -1, -1, -1, -1).reshape(Bw, h, N, N)
        out = attend(qkv[0], qkv[1], qkv[2], (C // h) ** -0.5, bias)
        return self.proj(out.transpose(1, 2).reshape(Bw, N, C))


class SwinBlock(nn.Module):
    """Pre-norm (shifted) window attention and MLP on tokens (B, H·W, C).
    `clamp_shift` (SwinTransformerSys) turns the shift off once the map is
    one window; the detection Swin of STViT (`clamp_shift=False`) rolls
    and masks within the lone window."""

    jax_renames = ((r"fc(\d)", r"mlp.fc\1"),)

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 shift_size: int = 0, mlp_ratio: float = 4.0, clamp_shift: bool = True):
        super().__init__()
        self.window_size, self.shift_size, self.clamp_shift = (window_size, shift_size,
                                                               clamp_shift)
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLP_FFN(dim, int(dim * mlp_ratio))

    def forward(self, x, H, W):
        B, N, C = x.shape
        ws = min(self.window_size, H, W)
        if ws != self.window_size:
            raise ValueError(f"a {H}×{W} map is smaller than the {self.window_size}² window")
        shift = self.shift_size
        if self.clamp_shift and ws >= min(H, W):
            shift = 0
        y = self.norm1(x).reshape(B, H, W, C)
        mask = None
        if shift > 0:
            y = torch.roll(y, (-shift, -shift), (1, 2))
            mask = torch.from_numpy(shift_mask_np(H, W, ws, shift)).to(x.device, x.dtype)
        y = window_reverse(self.attn(window_partition(y, ws), mask), ws, H, W)
        if shift > 0:
            y = torch.roll(y, (shift, shift), (1, 2))
        x = x + y.reshape(B, N, C)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """2×2 neighbours concatenated (4C), LayerNorm, bias-free linear to
    2C, on tokens."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, H, W):
        B, N, C = x.shape
        x = x.reshape(B, H, W, C)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], -1).reshape(B, N // 4, 4 * C)
        return self.reduction(self.norm(x))


def swin_blocks(dim, heads, depth, window_size, mlp_ratio=4.0, clamp_shift=True):
    """`depth` Swin blocks, the odd ones shifted by window_size // 2."""
    return nn.ModuleList(
        SwinBlock(dim, heads, window_size, 0 if i % 2 == 0 else window_size // 2,
                  mlp_ratio, clamp_shift) for i in range(depth))


class PatchEmbed(nn.Module):
    def __init__(self, in_ch: int, dim: int, patch: int = 4):
        super().__init__()
        self.proj = PromotingConv2d(in_ch, dim, patch, stride=patch, padding=0)
        self.norm = LayerNorm(dim)

    def forward(self, x):
        m = self.proj(x)
        B, H, W, C = m.shape
        return self.norm(m.reshape(B, H * W, C)), H, W


class BasicLayer(nn.Module):
    def __init__(self, dim, heads, depth, window_size, downsample: bool):
        super().__init__()
        self.blocks = swin_blocks(dim, heads, depth, window_size)
        self.downsample = PatchMerging(dim) if downsample else None

    def forward(self, t, H, W):
        for blk in self.blocks:
            t = blk(t, H, W)
        return t if self.downsample is None else self.downsample(t, H, W)


class BasicLayerUp(nn.Module):
    def __init__(self, dim, heads, depth, window_size, upsample: bool):
        super().__init__()
        self.blocks = swin_blocks(dim, heads, depth, window_size)
        self.upsample = PatchExpand(dim) if upsample else None


def _dec(m):
    return f"layers_up.{3 - int(m[1])}.blocks.{m[2]}"


class SwinUNet(nn.Module):
    """SwinTransformerSys: embed 96, depths 2/2/2/2, heads 3/6/12/24,
    window 7. (B, H, W, 1 | 3) → logits (B, H, W, num_classes)."""

    jax_renames = (("patch_embed", "patch_embed.proj"), ("embed_norm", "patch_embed.norm"),
                   (r"enc(\d)_b(\d+)", r"layers.\1.blocks.\2"),
                   (r"merge(\d)", r"layers.\1.downsample"),
                   ("expand2", "layers_up.0"),
                   (r"expand(\d)", lambda m: f"layers_up.{2 - int(m[1])}.upsample"),
                   (r"dec(\d)_b(\d+)", _dec),
                   (r"concat_linear(\d)", lambda m: f"concat_back_dim.{3 - int(m[1])}"),
                   ("final_expand", "up"))

    def __init__(self, num_classes: int = 9, img_size: int = 224, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7):
        super().__init__()
        dims = [embed_dim * 2 ** i for i in range(4)]
        self.patch_embed = PatchEmbed(3, embed_dim)
        self.layers = nn.ModuleList(
            BasicLayer(dims[s], num_heads[s], depths[s], window_size, s < 3)
            for s in range(4))
        self.norm = LayerNorm(dims[3])
        self.layers_up = nn.ModuleList(
            [PatchExpand(dims[3])]
            + [BasicLayerUp(dims[3 - i], num_heads[3 - i], depths[3 - i], window_size,
                            i < 3) for i in (1, 2, 3)])
        self.concat_back_dim = nn.ModuleList(
            [nn.Identity()] + [Linear(2 * dims[3 - i], dims[3 - i]) for i in (1, 2, 3)])
        self.norm_up = LayerNorm(dims[0])
        self.up = FinalPatchExpand_X4(dims[0])
        self.output = PromotingConv2d(dims[0], num_classes, 1, bias=False)

    def forward(self, x):
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        B = x.shape[0]
        t, H, W = self.patch_embed(x)
        skips = []
        for s, layer in enumerate(self.layers):
            skips.append(t)
            t = layer(t, H, W)
            if s < 3:
                H, W = H // 2, W // 2
        t = self.norm(t)
        t = self.layers_up[0](t.reshape(B, H, W, -1))
        H, W = 2 * H, 2 * W
        t = t.reshape(B, H * W, -1)
        for i in (1, 2, 3):
            up = self.layers_up[i]
            t = self.concat_back_dim[i](torch.cat([t, skips[3 - i]], -1))
            for blk in up.blocks:
                t = blk(t, H, W)
            if up.upsample is not None:
                t = up.upsample(t.reshape(B, H, W, -1))
                H, W = 2 * H, 2 * W
                t = t.reshape(B, H * W, -1)
        t = self.norm_up(t)
        return self.output(self.up(t.reshape(B, H, W, -1)))
