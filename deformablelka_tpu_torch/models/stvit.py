"""STViT: the super-token vision transformer, as STViT-LKA's encoder and
as the SemanticSTViT encoder-decoder.

Port of `deformablelka_tpu/models/stvit.py` (upstream's
`2D/networks/STViTLayers.py`, `STViTEncoder_LKADecoder.py` and
`STViTSegmentation.py`), channels-last, with upstream's torch attribute
names:

    SemanticAttentionBlock: each 7×7 window adaptive-max-pooled to 3×3
        super tokens (or the previous super tokens), which attend to the
        k×k patches around their window (stride 7, zero-padded; torch's
        `unfold`), with layer scales and a −1000 mask on padding;
    RestoreBlock: each image window attends to the 27×27 patch of the
        super-token grid around it (stride 3);
    STViTBlock: self-attention, global or in 3×3 windows of the super
        tokens; DeitStage: Swin, Semantic(14), Semantic(21), local and
        global blocks, Restore(27);
    STViT4Out: a stem of two 3²/2 conv + batch norm + hardswish, Swin
        stages (the detection Swin: shifted even on one window) at 96 and
        192, the super-token stage at 384, Swin at 768, a LayerNorm per
        output;
    STVitLKA: that encoder and the LKA Baseline's decoder (6
        `ops.kernels.dw_chain2d` launches per forward, as MViT-LKA's);
    SemanticSTViT: 7 stages with no skips, ×4 expansion and a 1×1 head.
        Its 4th stage's super-token block is dead upstream (computed,
        never read) and is not built.

`adaptive_max_pool` and `extract_patches` are torch's
`adaptive_max_pool2d` and `unfold`.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from deformablelka_tpu_torch.models.maxvit_dlka import FinalPatchExpand_X4, PatchExpand
from deformablelka_tpu_torch.models.mvit import lka_decoders
from deformablelka_tpu_torch.models.swinunet import PatchMerging, SwinBlock, window_partition
from deformablelka_tpu_torch.nn.layers import Conv2d, Linear
from deformablelka_tpu_torch.nn.norms import BatchNorm, LayerNorm
from deformablelka_tpu_torch.nn.segformer import MLP_FFN, attend
from deformablelka_tpu_torch.ops.convs import to_nchw, to_nhwc


def adaptive_max_pool(x, out_size: int):
    """torch's adaptive_max_pool2d of an NHWC map → (B, out, out, C)."""
    return to_nhwc(F.adaptive_max_pool2d(to_nchw(x), out_size))


def extract_patches(x, k: int, stride: int, pad_lo: int, pad_hi: int):
    """torch's `unfold` of the zero-padded NHWC map: (B, nW, k·k, C),
    windows and their pixels row-major."""
    B, H, W, C = x.shape
    xp = F.pad(to_nchw(x), (pad_lo, pad_hi, pad_lo, pad_hi))
    cols = F.unfold(xp, k, stride=stride)                 # (B, C·k·k, nW)
    return cols.reshape(B, C, k * k, -1).permute(0, 3, 2, 1)


@functools.lru_cache(maxsize=None)
def pad_mask_np(Hp, Wp, pad_b, pad_r, k, stride, pad_lo, pad_hi, n_q):
    """upstream's pad mask: −1000 on the padded pixels of each k×k patch,
    (nW, 1, n_q, k·k); None when nothing is padded (a softmax no-op)."""
    if pad_b == 0 and pad_r == 0:
        return None
    core = np.zeros((Hp, Wp), np.float32)
    rs = slice(-pad_b, None) if pad_b > 0 else slice(None)
    cs = slice(-pad_r, None) if pad_r > 0 else slice(None)
    core[rs, cs] = -1000.0
    core = np.pad(core, ((pad_lo, pad_hi), (pad_lo, pad_hi)), constant_values=-1000.0)
    nW_h = (core.shape[0] - k) // stride + 1
    nW_w = (core.shape[1] - k) // stride + 1
    wins = np.zeros((nW_h * nW_w, k * k), np.float32)
    for i in range(nW_h):
        for j in range(nW_w):
            wins[i * nW_w + j] = core[i * stride:i * stride + k,
                                      j * stride:j * stride + k].reshape(-1)
    return np.ascontiguousarray(np.broadcast_to(wins[:, None, None, :],
                                                (len(wins), 1, n_q, k * k)))


def _mask(x, B, *args):
    m = pad_mask_np(*args)
    return None if m is None else torch.from_numpy(m).to(x.device, x.dtype).repeat(B, 1, 1, 1)


class CrossAttention(nn.Module):
    """upstream's Attention: q from x, k and v from y, an additive mask."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q = Linear(dim, dim)
        self.kv = Linear(dim, 2 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x, y, mask=None):
        B, N1, C = x.shape
        N2, h = y.shape[1], self.num_heads
        q = self.q(x).reshape(B, N1, h, C // h).transpose(1, 2)
        kv = self.kv(y).reshape(B, N2, 2, h, C // h).permute(2, 0, 3, 1, 4)
        o = attend(q, kv[0], kv[1], (C // h) ** -0.5, mask)
        return self.proj(o.transpose(1, 2).reshape(B, N1, C))


class _ScaledBlock(nn.Module):
    """norm1, attn, norm2, mlp and the two layer scales (1e-5 at init)."""

    jax_renames = ((r"fc(\d)", r"mlp.fc\1"),)

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = CrossAttention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLP_FFN(dim, int(dim * mlp_ratio))
        self.layer_scale_1 = nn.Parameter(torch.empty(dim))
        self.layer_scale_2 = nn.Parameter(torch.empty(dim))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.layer_scale_1.fill_(1e-5)
            self.layer_scale_2.fill_(1e-5)

    def _mlp(self, x):
        return x + self.layer_scale_2 * self.mlp(self.norm2(x))


class STViTBlock(_ScaledBlock):
    """Self-attention of the super tokens, global or in `window_size`²
    windows."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 3, local: bool = False,
                 mlp_ratio: float = 4.0):
        super().__init__(dim, num_heads, mlp_ratio)
        self.window_size, self.local = window_size, local

    def forward(self, x, H, W):
        B, L, C = x.shape
        n = self.norm1(x)
        if self.local:
            ws = self.window_size
            w = window_partition(n.reshape(B, H, W, C), ws)
            a = self.attn(w, w).reshape(B, H // ws, W // ws, ws, ws, C)
            a = a.permute(0, 1, 3, 2, 4, 5).reshape(B, L, C)
        else:
            a = self.attn(n, n)
        return self._mlp(x + self.layer_scale_1 * a)


class SemanticAttentionBlock(_ScaledBlock):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 window_sample_size: int = 3, k_window_size: int = 14,
                 mlp_ratio: float = 4.0):
        super().__init__(dim, num_heads, mlp_ratio)
        self.ws, self.ss, self.kws = window_size, window_sample_size, k_window_size

    def forward(self, x, H, W, y=None):
        B, L, C = x.shape
        ws, ss, kws = self.ws, self.ss, self.kws
        x = x.reshape(B, H, W, C)
        pad_r, pad_b = (-W) % ws, (-H) % ws
        if pad_r or pad_b:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        nwh, nww = Hp // ws, Wp // ws
        if y is None:
            wins = window_partition(x, ws).reshape(-1, ws, ws, C)
            shortcut = adaptive_max_pool(wins, ss).reshape(-1, ss * ss, C)
        else:
            shortcut = window_partition(y.reshape(B, nwh * ss, nww * ss, C), ss)
        left = (kws - ws) // 2
        kwin = extract_patches(x, kws, ws, left, kws - ws - left)
        kwin = self.norm1(kwin.reshape(B, -1, C)).reshape(-1, kws * kws, C)
        mask = _mask(x, B, Hp, Wp, pad_b, pad_r, kws, ws, left, kws - ws - left, ss * ss)
        s = shortcut + self.layer_scale_1 * self.attn(self.norm1(shortcut), kwin, mask)
        s = s.reshape(B, nwh, nww, ss, ss, C).permute(0, 1, 3, 2, 4, 5)
        s = s.reshape(B, nwh * ss * nww * ss, C)
        return self._mlp(s), nwh * ss, nww * ss


class RestoreBlock(_ScaledBlock):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 window_sample_size: int = 3, k_window_size: int = 27,
                 mlp_ratio: float = 4.0):
        super().__init__(dim, num_heads, mlp_ratio)
        self.ws, self.ss, self.kws = window_size, window_sample_size, k_window_size

    def forward(self, x, y, H, W):
        B, L, C = x.shape
        ws, ss, kws = self.ws, self.ss, self.kws
        x = x.reshape(B, H, W, C)
        pad_r, pad_b = (-W) % ws, (-H) % ws
        if pad_r or pad_b:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        nwh, nww = Hp // ws, Wp // ws
        s_H, s_W = nwh * ss, nww * ss
        shortcut = window_partition(x, ws)
        left = (kws - ss) // 2
        kwin = extract_patches(y.reshape(B, s_H, s_W, C), kws, ss, left, kws - ss - left)
        kwin = self.norm1(kwin.reshape(B, -1, C)).reshape(-1, kws * kws, C)
        mask = _mask(x, B, s_H, s_W, pad_b, pad_r, kws, ss, left, kws - ss - left, ws * ws)
        o = shortcut + self.layer_scale_1 * self.attn(self.norm1(shortcut), kwin, mask)
        o = o.reshape(B, nwh, nww, ws, ws, C).permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
        return self._mlp(o[:, :H, :W].reshape(B, H * W, C))


class DeitStage(nn.Module):
    """The depth-6 super-token stage; `downsample`/`upsample` the parent's
    PatchMerging or PatchExpand after it."""

    jax_renames = ((r"blk(\d)", r"blocks.\1"),)

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 window_sample_size: int = 3, k_window_size_1: int = 14,
                 k_window_size_2: int = 21, restore_k_window_size: int = 27,
                 mlp_ratio: float = 4.0):
        super().__init__()
        ws, ss = window_size, window_sample_size
        self.blocks = nn.ModuleList([
            SwinBlock(dim, num_heads, ws, 0, mlp_ratio),
            SemanticAttentionBlock(dim, num_heads, ws, ss, k_window_size_1, mlp_ratio),
            SemanticAttentionBlock(dim, num_heads, ws, ss, k_window_size_2, mlp_ratio),
            STViTBlock(dim, num_heads, ss, True, mlp_ratio),
            STViTBlock(dim, num_heads, ss, False, mlp_ratio),
            RestoreBlock(dim, num_heads, ws, ss, restore_k_window_size, mlp_ratio)])

    def forward(self, x, H, W):
        swin, sem1, sem2, local, glob, restore = self.blocks
        x = swin(x, H, W)
        s, s_H, s_W = sem1(x, H, W)
        s, _, _ = sem2(x, H, W, y=s)
        s = glob(local(s, s_H, s_W), s_H, s_W)
        return restore(x, s, H, W)


class SwinLayer(nn.Module):
    """A stage of `depth` detection-Swin blocks (shifted even on one
    window)."""

    def __init__(self, dim: int, heads: int, depth: int, window_size: int = 7,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, window_size, 0 if i % 2 == 0 else window_size // 2,
                      mlp_ratio, clamp_shift=False) for i in range(depth))

    def forward(self, t, H, W):
        for blk in self.blocks:
            t = blk(t, H, W)
        return t


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.c = Conv2d(cin, cout, 3, stride=2, padding=1, bias=False)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return self.bn(self.c(x))


class PatchEmbed(nn.Module):
    """Two 3²/2 conv + batch norm, each followed by hardswish."""

    def __init__(self, in_ch: int, dim: int):
        super().__init__()
        self.proj = nn.Sequential(ConvBN(in_ch, dim // 2), nn.Hardswish(), ConvBN(dim // 2, dim))

    def forward(self, x):
        return F.hardswish(self.proj(x))


_STEM = (("stem_conv1", "patch_embed.proj.0.c"), ("stem_bn1", "patch_embed.proj.0.bn"),
         ("stem_conv2", "patch_embed.proj.2.c"), ("stem_bn2", "patch_embed.proj.2.bn"))


class STViT4Out(nn.Module):
    """NHWC maps 96 @ /4, 192 @ /8, 384 @ /16, 768 @ /32."""

    jax_renames = _STEM + ((r"stage(\d)_blk(\d+)", r"layers.\1.blocks.\2"),
                           (r"stage(\d)", r"layers.\1"),
                           (r"downsample(\d)", r"layers.\1.downsample"))

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 window_sample_size: int = 3, k_window_size_1: int = 14,
                 k_window_size_2: int = 21, restore_k_window_size: int = 27,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.patch_embed = PatchEmbed(3, embed_dim)
        layers = []
        for s in range(4):
            dim = embed_dim * 2 ** s
            if s == 2:
                layer = DeitStage(dim, num_heads[s], window_size, window_sample_size,
                                  k_window_size_1, k_window_size_2, restore_k_window_size,
                                  mlp_ratio)
            else:
                layer = SwinLayer(dim, num_heads[s], depths[s], window_size, mlp_ratio)
            layer.downsample = PatchMerging(dim) if s < 3 else None
            layers.append(layer)
            setattr(self, f"norm{s}", LayerNorm(dim))
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        h = self.patch_embed(x)
        B, H, W, C = h.shape
        t = h.reshape(B, H * W, C)
        outs = []
        for s, layer in enumerate(self.layers):
            t = layer(t, H, W)
            outs.append(getattr(self, f"norm{s}")(t).reshape(B, H, W, -1))
            if layer.downsample is not None:
                t = layer.downsample(t, H, W)
                H, W = H // 2, W // 2
        return outs


class STVitLKA(nn.Module):
    """(B, H, W, 1 | 3) → logits (B, H, W, num_classes)."""

    jax_renames = ()

    def __init__(self, num_classes: int = 9, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2), num_heads: Sequence[int] = (3, 6, 12, 24)):
        super().__init__()
        self.backbone = STViT4Out(embed_dim, depths, num_heads)
        d = embed_dim
        self.decoder_3, self.decoder_2, self.decoder_1, self.decoder_0 = lka_decoders(
            (d, 2 * d, 4 * d, 8 * d), num_classes)

    def forward(self, x):
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        e0, e1, e2, e3 = self.backbone(x)
        t = self.decoder_2(self.decoder_3(e3), e2)
        return self.decoder_0(self.decoder_1(t, e1), e0)


class SemanticSTViT(nn.Module):
    """STViTSegmentation: Swin(2) @ 96 → Swin(2) @ 192 → Deit @ 384 →
    Swin(6) @ 768 + expand → Swin @ 384 + expand → Swin(2) @ 192 + expand
    → Swin(2) @ 96, ×4 expansion, 1×1 head; no skips."""

    jax_renames = _STEM + ((r"(?:enc|dec)(\d)_blk(\d+)", r"layers.\1.blocks.\2"),
                           (r"enc(\d)", r"layers.\1"),
                           (r"down(\d)", r"layers.\1.downsample"),
                           (r"up(\d)", r"layers.\1.upsample"))

    def __init__(self, num_classes: int = 9, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 6, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24, 12, 6, 3), window_size: int = 7):
        super().__init__()
        d, ws = embed_dim, window_size
        self.patch_embed = PatchEmbed(3, d)
        dims = (d, 2 * d, 4 * d, 8 * d, 4 * d, 2 * d, d)
        layers = []
        for L, dim in enumerate(dims):
            if L == 2:
                layer = DeitStage(dim, num_heads[L], ws)
            elif L == 4:   # its super-token block is dead upstream
                layer = SwinLayer(dim, num_heads[L], 1, ws)
            else:
                layer = SwinLayer(dim, num_heads[L], depths[L], ws)
            if L < 3:
                layer.downsample = PatchMerging(dim)
            elif L < 6:
                layer.upsample = PatchExpand(dim)
            else:
                layer.upsample = FinalPatchExpand_X4(dim)
            layers.append(layer)
        self.layers = nn.ModuleList(layers)
        self.last_layer = Conv2d(d, num_classes, 1)

    def forward(self, x):
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        h = self.patch_embed(x)
        B, H, W, C = h.shape
        t = h.reshape(B, H * W, C)
        for L, layer in enumerate(self.layers):
            t = layer(t, H, W)
            if L < 3:
                t = layer.downsample(t, H, W)
                H, W = H // 2, W // 2
            elif L < 6:
                t = layer.upsample(t.reshape(B, H, W, -1))
                H, W = 2 * H, 2 * W
                t = t.reshape(B, H * W, -1)
        return self.last_layer(self.layers[6].upsample(t.reshape(B, H, W, -1)))
