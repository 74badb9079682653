"""DAT-LKA: the Deformable Attention Transformer encoder and the LKA
decoder.

Port of `deformablelka_tpu/models/dat_lka.py` (upstream's
`2D/networks/DAT/dat_4out.py`, `dat_blocks.py` and `DAT_LKA_Decoder.py`),
channels-last, with upstream's torch attribute names: a 4×4/4 conv stem
and LayerNorm, dims 96/192/384/768, depths 2/2/18/2, stage specs
"LS", "LS", "LD"×9, "LD", 2×2/2 down projections:

    'L' LocalAttentionDAT: 7×7 window attention, relative-position bias
        table;
    'S' the same rolled by ceil(7 / 2) = 4 (not Swin's floor), with the
        block mask;
    'D' DAttention: per group offsets from a depthwise conv, LayerNorm,
        GELU and a 1×1 conv, bounded by tanh to 2 / map size; k and v
        sampled bilinearly (align_corners, zero outside:
        `ops.deform2d.grid_sample_bilinear`) at the reference grid plus
        the offsets; dense queries against the samples; the (heads, 2H−1,
        2W−1) rpe table sampled at each query-to-sample displacement.

The decoder is the LKA Baseline's: 6 `ops.kernels.dw_chain2d` launches
per forward at 14²×384, 28²×192 and 56²×96.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from deformablelka_tpu_torch.models.mvit import lka_decoders
from deformablelka_tpu_torch.models.swinunet import (relative_position_index, shift_mask_np,
                                                     window_partition, window_reverse)
from deformablelka_tpu_torch.nn.layers import Conv2d, Linear
from deformablelka_tpu_torch.nn.norms import LayerNorm
from deformablelka_tpu_torch.nn.segformer import attend
from deformablelka_tpu_torch.ops.deform2d import grid_sample_bilinear


def _trunc_normal_(t, std, generator):
    """N(0, std²) truncated to ±2 std, as `jax.nn.initializers.
    truncated_normal(std)` draws it."""
    with torch.no_grad():
        t.normal_(0.0, 1.0, generator=generator)
        while True:
            bad = t.abs() > 2
            if not bad.any():
                break
            t[bad] = torch.randn(int(bad.sum()), generator=generator)
        t.mul_(std)


class LayerNormProxy(nn.Module):
    """upstream's channel LayerNorm of NCHW maps: here a LayerNorm of the
    NHWC map's last axis."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim)

    def forward(self, x):
        return self.norm(x)


class LocalAttentionDAT(nn.Module):
    """LocalAttention, or ShiftWindowAttention when `shift` > 0."""

    def __init__(self, dim: int, heads: int, window_size: int = 7, shift: int = 0):
        super().__init__()
        self.heads, self.window_size, self.shift = heads, window_size, shift
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window_size - 1) ** 2, heads))
        self.proj_qkv = Linear(dim, 3 * dim)
        self.proj_out = Linear(dim, dim)
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(window_size).reshape(-1)), persistent=False)

    def reset_parameters(self, generator=None):
        _trunc_normal_(self.relative_position_bias_table, 0.01, generator)

    def forward(self, x):
        B, H, W, C = x.shape
        ws, h, s = self.window_size, self.heads, self.shift
        if s:
            x = torch.roll(x, (-s, -s), (1, 2))
        win = window_partition(x, ws)                         # (B·nW, ws², C)
        q, k, v = (t.reshape(-1, ws * ws, h, C // h).transpose(1, 2)
                   for t in self.proj_qkv(win).chunk(3, -1))
        n = ws * ws
        bias = self.relative_position_bias_table[self.relative_position_index]
        bias = bias.reshape(n, n, h).permute(2, 0, 1)[None]
        if s:
            mask = torch.from_numpy(shift_mask_np(H, W, ws, s)).to(x.device, x.dtype)
            nW = mask.shape[0]
            bias = (bias[:, None] + mask[None, :, None]).expand(B, -1, -1, -1, -1)
            bias = bias.reshape(B * nW, h, n, n)
        out = attend(q * (C // h) ** -0.5, k, v, 1.0, bias)
        out = self.proj_out(out.transpose(1, 2).reshape(-1, n, C))
        out = window_reverse(out, ws, H, W)
        return torch.roll(out, (s, s), (1, 2)) if s else out


def _ref_grid(H, W, device, dtype):
    """Pixel centres in [−1, 1], (H, W, 2) as (y, x)."""
    ry = (torch.arange(H, device=device, dtype=dtype) + 0.5) / H * 2 - 1
    rx = (torch.arange(W, device=device, dtype=dtype) + 0.5) / W * 2 - 1
    return torch.stack(torch.meshgrid(ry, rx, indexing="ij"), -1)


class DAttention(nn.Module):
    """DAttentionBaseline on an NHWC map of `fmap_size`²."""

    jax_renames = (("offset_dw", "conv_offset.0"), ("offset_norm", "conv_offset.1.norm"),
                   ("offset_proj", "conv_offset.3"))

    def __init__(self, dim: int, n_heads: int, n_groups: int, stage_idx: int,
                 fmap_size: int, offset_range_factor: float = 2.0, use_pe: bool = True):
        super().__init__()
        self.n_heads, self.n_groups = n_heads, n_groups
        self.offset_range_factor, self.use_pe = offset_range_factor, use_pe
        cg = dim // n_groups
        kk = (9, 7, 5, 3)[stage_idx]
        self.conv_offset = nn.Sequential(
            Conv2d(cg, cg, kk, padding=kk // 2, groups=cg),
            LayerNormProxy(cg), nn.GELU(), Conv2d(cg, 2, 1, bias=False))
        self.proj_q = Conv2d(dim, dim, 1)
        self.proj_k = Conv2d(dim, dim, 1)
        self.proj_v = Conv2d(dim, dim, 1)
        self.proj_out = Conv2d(dim, dim, 1)
        if use_pe:
            self.rpe_table = nn.Parameter(
                torch.empty(n_heads, 2 * fmap_size - 1, 2 * fmap_size - 1))

    def reset_parameters(self, generator=None):
        if self.use_pe:
            _trunc_normal_(self.rpe_table, 0.01, generator)

    def forward(self, x):
        B, H, W, C = x.shape
        g, h = self.n_groups, self.n_heads
        cg, hc = C // g, C // h
        q = self.proj_q(x)
        q_off = q.reshape(B, H, W, g, cg).permute(0, 3, 1, 2, 4).reshape(B * g, H, W, cg)
        offset = self.conv_offset(q_off)                       # (B·g, Hk, Wk, 2)
        Hk, Wk = offset.shape[1:3]
        if self.offset_range_factor > 0:
            rng = torch.tensor([1.0 / Hk, 1.0 / Wk], device=x.device, dtype=offset.dtype)
            offset = torch.tanh(offset) * rng * self.offset_range_factor
        ref = _ref_grid(Hk, Wk, x.device, offset.dtype)
        pos = offset + ref if self.offset_range_factor >= 0 else torch.tanh(offset + ref)
        xs = x.reshape(B, H, W, g, cg).permute(0, 3, 1, 2, 4).reshape(B * g, H, W, cg)
        sampled = grid_sample_bilinear(xs, pos.flip(-1))       # (B·g, Hk, Wk, cg)
        ns = Hk * Wk
        sampled = sampled.reshape(B, g, ns, cg).transpose(1, 2).reshape(B, ns, C)
        k = torch.nn.functional.linear(sampled, self.proj_k.weight[:, :, 0, 0],
                                       self.proj_k.bias)
        v = torch.nn.functional.linear(sampled, self.proj_v.weight[:, :, 0, 0],
                                       self.proj_v.bias)
        qh = q.reshape(B, H * W, h, hc).transpose(1, 2)
        kh = k.reshape(B, ns, h, hc).transpose(1, 2)
        vh = v.reshape(B, ns, h, hc).transpose(1, 2)
        bias = None
        if self.use_pe:
            q_grid = _ref_grid(H, W, x.device, offset.dtype).reshape(H * W, 2)
            disp = (q_grid[None, :, None, :] - pos.reshape(B * g, 1, ns, 2)) * 0.5
            rpe = self.rpe_table.reshape(1, g, h // g, 2 * H - 1, 2 * W - 1).expand(
                B, -1, -1, -1, -1).reshape(B * g, h // g, 2 * H - 1, 2 * W - 1)
            bias = grid_sample_bilinear(rpe.permute(0, 2, 3, 1), disp.flip(-1))
            bias = bias.permute(0, 3, 1, 2).reshape(B, h, H * W, ns)
        out = attend(qh, kh, vh, hc ** -0.5, bias)
        return self.proj_out(out.transpose(1, 2).reshape(B, H, W, C))


class TokenMLP(nn.Module):
    """TransformerMLP: linear1 → GELU → linear2 under `chunk`."""

    jax_renames = ((r"linear(\d)", r"chunk.linear\1"),)

    def __init__(self, dim: int, expansion: int = 4):
        super().__init__()
        self.chunk = nn.Sequential()
        self.chunk.add_module("linear1", Linear(dim, dim * expansion))
        self.chunk.add_module("act", nn.GELU())
        self.chunk.add_module("linear2", Linear(dim * expansion, dim))

    def forward(self, x):
        return self.chunk(x)


class DATStage(nn.Module):
    """TransformerStage: per letter of `spec`, pre-norm residual attention
    ('L', 'S' or 'D') and pre-norm residual token MLP."""

    jax_renames = ((r"layer_norms_(\d+)", r"layer_norms.\1.norm"),
                   (r"attns_(\d+)", r"attns.\1"), (r"mlps_(\d+)", r"mlps.\1"))

    def __init__(self, dim: int, n_heads: int, spec: str, n_groups: int, stage_idx: int,
                 fmap_size: int, use_pe: bool = False, offset_range_factor: float = 2.0,
                 window_size: int = 7, expansion: int = 4):
        super().__init__()
        attns = []
        for letter in spec:
            if letter == "L":
                attns.append(LocalAttentionDAT(dim, n_heads, window_size))
            elif letter == "S":
                attns.append(LocalAttentionDAT(dim, n_heads, window_size,
                                               shift=-(-window_size // 2)))
            else:
                attns.append(DAttention(dim, n_heads, n_groups, stage_idx, fmap_size,
                                        offset_range_factor, use_pe))
        self.layer_norms = nn.ModuleList(LayerNormProxy(dim) for _ in range(2 * len(spec)))
        self.attns = nn.ModuleList(attns)
        self.mlps = nn.ModuleList(TokenMLP(dim, expansion) for _ in spec)

    def forward(self, x):
        for d, (attn, mlp) in enumerate(zip(self.attns, self.mlps)):
            x = x + attn(self.layer_norms[2 * d](x))
            x = x + mlp(self.layer_norms[2 * d + 1](x))
        return x


class DATEncoder(nn.Module):
    """DAT at DATLKAFormer's configuration: NHWC maps at /4 … /32."""

    jax_renames = (("patch_proj", "patch_proj.0"), ("patch_norm", "patch_proj.1.norm"),
                   (r"stages_(\d)", r"stages.\1"), (r"down_projs_(\d)", r"down_projs.\1.0"),
                   (r"down_norm_(\d)", r"down_projs.\1.1.norm"))

    def __init__(self, img_size: int = 224, dims: Sequence[int] = (96, 192, 384, 768),
                 depths: Sequence[int] = (2, 2, 18, 2), heads: Sequence[int] = (3, 6, 12, 24),
                 groups: Sequence[int] = (-1, -1, 3, 6),
                 stage_spec: Sequence[str] = ("LS", "LS", "LD" * 9, "LD"),
                 use_pes: Sequence[bool] = (False, False, True, True),
                 offset_range: Sequence[float] = (-1.0, -1.0, 2.0, 2.0)):
        super().__init__()
        self.patch_proj = nn.Sequential(Conv2d(3, dims[0], 4, stride=4, padding=0),
                                        LayerNormProxy(dims[0]))
        self.stages = nn.ModuleList(
            DATStage(dims[s], heads[s], stage_spec[s][:depths[s]], groups[s], s,
                     img_size // 4 >> s, use_pes[s], offset_range[s]) for s in range(4))
        self.down_projs = nn.ModuleList(
            nn.Sequential(Conv2d(dims[s], dims[s + 1], 2, stride=2, padding=0, bias=False),
                          LayerNormProxy(dims[s + 1])) for s in range(3))

    def forward(self, x):
        h = self.patch_proj(x)
        outs = []
        for s, stage in enumerate(self.stages):
            h = stage(h)
            outs.append(h)
            if s < 3:
                h = self.down_projs[s](h)
        return outs


class DATLKAFormer(nn.Module):
    """(B, H, W, 1 | 3) → logits (B, H, W, num_classes)."""

    jax_renames = ()

    def __init__(self, num_classes: int = 9, img_size: int = 224,
                 dims: Sequence[int] = (96, 192, 384, 768), depths: Sequence[int] = (2, 2, 18, 2),
                 heads: Sequence[int] = (3, 6, 12, 24), groups: Sequence[int] = (-1, -1, 3, 6),
                 stage_spec: Sequence[str] = ("LS", "LS", "LD" * 9, "LD"),
                 use_pes: Sequence[bool] = (False, False, True, True),
                 offset_range: Sequence[float] = (-1.0, -1.0, 2.0, 2.0)):
        super().__init__()
        self.backbone = DATEncoder(img_size, dims, depths, heads, groups, stage_spec, use_pes,
                                   offset_range)
        self.decoder_3, self.decoder_2, self.decoder_1, self.decoder_0 = lka_decoders(
            dims, num_classes)

    def forward(self, x):
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        e0, e1, e2, e3 = self.backbone(x)
        t = self.decoder_2(self.decoder_3(e3), e2)
        return self.decoder_0(self.decoder_1(t, e1), e0)

