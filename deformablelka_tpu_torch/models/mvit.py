"""MViT-LKA: the MViTv2 4-scale encoder and the LKA decoder.

Port of `deformablelka_tpu/models/mvit.py` (upstream's
`2D/networks/mvit_model_object_4out.py`, `mvit_utils.py` and
`mvit_LKA_Decoder.py`), channels-last, with upstream's torch attribute
names: a 7×7/4 patch embedding to 56²×96, 16 multi-scale blocks ending
stages at blocks 0, 2, 11 and 15; q pooled by 2 in the block after each
stage end; window attention (window 56, halved per stage) except in the
stage-end blocks 2, 11 and 15, which attend globally; k and v pooled by 4,
halved per stage (doubled in blocks 2 and 11); per-head depthwise 3×3
pooling convs with a LayerNorm; decomposed relative positions; residual
pooling; a LayerNorm per output (96 at /4 … 768 at /32). The decoder is
the LKA Baseline's (`models/maxvit_dlka.py`, `deformable=False`): each of
decoder_2, _1 and _0 runs `ops.kernels.dw_chain2d` twice, 6 launches per
forward at 14²×384, 28²×192 and 56²×96.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from deformablelka_tpu_torch.models.maxvit_dlka import DecoderLayer
from deformablelka_tpu_torch.nn.layers import Conv2d, Linear
from deformablelka_tpu_torch.nn.norms import LayerNorm
from deformablelka_tpu_torch.nn.segformer import MLP_FFN
from deformablelka_tpu_torch.ops.convs import to_nchw, to_nhwc


def window_partition(x, ws: int):
    """(B, H, W, C) → (B·nW, ws, ws, C), zero-padded to the window grid;
    and the padded (Hp, Wp)."""
    B, H, W, C = x.shape
    pad_h, pad_w = (-H) % ws, (-W) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, C), (Hp, Wp)


def window_unpartition(w, ws: int, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = w.shape[0] // (Hp * Wp // ws // ws)
    x = w.reshape(B, Hp // ws, Wp // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)[:, :H, :W]


def rel_pos_index(q_size: int, k_size: int) -> np.ndarray:
    """get_rel_pos's rows of the (2·max − 1)-row table for each (q, k)
    pair: the scaled coordinate distance."""
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel.astype(np.int64)


def add_decomposed_rel_pos(attn, q, rel_h, rel_w, q_hw, k_hw):
    """attn (B, q_h·q_w, k_h·k_w) plus the decomposed relative-position
    terms of q (B, q_h·q_w, c) against the tables rel_h, rel_w."""
    (q_h, q_w), (k_h, k_w) = q_hw, k_hw
    Rh = rel_h[torch.from_numpy(rel_pos_index(q_h, k_h)).to(rel_h.device)]
    Rw = rel_w[torch.from_numpy(rel_pos_index(q_w, k_w)).to(rel_w.device)]
    B, _, dim = q.shape
    r_q = q.reshape(B, q_h, q_w, dim)
    bh = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    bw = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    attn = attn.reshape(B, q_h, q_w, k_h, k_w) + bh[..., None] + bw[..., None, :]
    return attn.reshape(B, q_h * q_w, k_h * k_w)


class MultiScaleAttention(nn.Module):
    """Pooled multi-head attention; `window_size` 0 is global."""

    jax_renames = ((r"(q|k|v)_pool/pool", r"pool_\1"), (r"(q|k|v)_pool/norm", r"norm_\1"))

    def __init__(self, dim: int, dim_out: int, num_heads: int, stride_q: int = 1,
                 stride_kv: int = 1, window_size: int = 0,
                 input_size: Tuple[int, int] = (56, 56)):
        super().__init__()
        self.num_heads, self.dim_out = num_heads, dim_out
        self.stride_q, self.stride_kv, self.window_size = stride_q, stride_kv, window_size
        hd = dim_out // num_heads
        self.qkv = Linear(dim, 3 * dim_out)
        self.proj = Linear(dim_out, dim_out)
        for n, s in (("q", stride_q), ("k", stride_kv), ("v", stride_kv)):
            setattr(self, f"pool_{n}", Conv2d(hd, hd, 3, stride=s, padding=1, groups=hd,
                                              bias=False))
            setattr(self, f"norm_{n}", LayerNorm(hd))
        size = input_size[0]
        rel_dim = 2 * max(size // stride_q, size // stride_kv) - 1
        self.rel_pos_h = nn.Parameter(torch.zeros(rel_dim, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(rel_dim, hd))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.rel_pos_h.zero_()
            self.rel_pos_w.zero_()

    def forward(self, x):
        B, H, W, _ = x.shape
        nh = self.num_heads
        hd = self.dim_out // nh
        qkv = self.qkv(x).reshape(B, H, W, 3, nh, hd).permute(3, 0, 4, 1, 2, 5)
        q, k, v = qkv.reshape(3, B * nh, H, W, hd)
        q = self.norm_q(self.pool_q(q))
        k = self.norm_k(self.pool_k(k))
        v = self.norm_v(self.pool_v(v))
        ori_q = q
        if self.window_size:
            q_win = self.window_size // self.stride_q
            kv_win = self.window_size // self.stride_kv
            q, q_pad = window_partition(q, q_win)
            k, _ = window_partition(k, kv_win)
            v, _ = window_partition(v, kv_win)
            q_hw, k_hw = (q_win, q_win), (kv_win, kv_win)
        else:
            q_hw, k_hw = tuple(q.shape[1:3]), tuple(k.shape[1:3])
        nq = q.shape[0]
        q = q.reshape(nq, q_hw[0] * q_hw[1], hd)
        k = k.reshape(nq, k_hw[0] * k_hw[1], hd)
        v = v.reshape(nq, k_hw[0] * k_hw[1], hd)
        attn = torch.matmul(q * hd ** -0.5, k.transpose(1, 2))
        attn = add_decomposed_rel_pos(attn, q, self.rel_pos_h, self.rel_pos_w, q_hw, k_hw)
        out = torch.matmul(torch.softmax(attn.float(), -1).to(v.dtype), v)
        out = out.reshape(nq, q_hw[0], q_hw[1], hd)
        if self.window_size:
            out = window_unpartition(out, q_win, q_pad, ori_q.shape[1:3])
        out = out + ori_q   # residual pooling
        Hq, Wq = out.shape[1:3]
        out = out.reshape(B, nh, Hq, Wq, hd).permute(0, 2, 3, 1, 4)
        return self.proj(out.reshape(B, Hq, Wq, self.dim_out))


class MultiScaleBlock(nn.Module):
    """Pre-norm pooled attention and MLP (ratio 4); where the width
    changes the skip is a linear map of the normalised input, and where q
    is pooled the skip is max-pooled (k = stride + 1)."""

    jax_renames = ((r"mlp_fc(\d)", r"mlp.fc\1"),)

    def __init__(self, dim: int, dim_out: int, num_heads: int, stride_q: int = 1,
                 stride_kv: int = 1, window_size: int = 0,
                 input_size: Tuple[int, int] = (56, 56), mlp_ratio: float = 4.0):
        super().__init__()
        self.stride_q = stride_q
        self.norm1 = LayerNorm(dim)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads, stride_q, stride_kv,
                                        window_size, input_size)
        self.proj = Linear(dim, dim_out) if dim != dim_out else None
        self.norm2 = LayerNorm(dim_out)
        self.mlp = MLP_FFN(dim_out, int(dim_out * mlp_ratio))

    def forward(self, x):
        xn = self.norm1(x)
        xb = self.attn(xn)
        if self.proj is not None:
            x = self.proj(xn)
        if self.stride_q > 1:
            ks = self.stride_q + 1
            x = to_nhwc(F.max_pool2d(to_nchw(x), ks, self.stride_q, ks // 2))
        x = x + xb
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, in_ch: int, dim: int):
        super().__init__()
        self.proj = Conv2d(in_ch, dim, 7, stride=4, padding=3)

    def forward(self, x):
        return self.proj(x)


class MViT4Out(nn.Module):
    """(B, H, W, 3) → [96 @ /4, 192 @ /8, 384 @ /16, 768 @ /32] at the
    default widths."""

    jax_renames = (("patch_embed", "patch_embed.proj"), (r"block(\d+)", r"blocks.\1"))

    def __init__(self, img_size: int = 224, embed_dim: int = 96, depth: int = 16,
                 last_block_indexes: Sequence[int] = (0, 2, 11, 15)):
        super().__init__()
        last = tuple(last_block_indexes)
        self.last = last
        self.patch_embed = PatchEmbed(3, embed_dim)
        # one head, k and v pooled by 4 and windows of 56 in the first stage
        dim, dim_out, heads = embed_dim, embed_dim, 1
        stride_kv, window_size = 4, 56
        input_size = (img_size // 4, img_size // 4)
        blocks = []
        for i in range(depth):
            blocks.append(MultiScaleBlock(
                dim, dim_out, heads, stride_q=2 if (i - 1) in last else 1,
                stride_kv=stride_kv * 2 if i in (last[1], last[2]) else stride_kv,
                window_size=0 if i in last[1:] else window_size, input_size=input_size))
            dim = dim_out
            if i in last:
                setattr(self, f"scale{last.index(i) + 2}_norm", LayerNorm(dim))
                dim_out, heads = 2 * dim_out, 2 * heads
                stride_kv = max(stride_kv // 2, 1)
            if (i - 1) in last:
                window_size //= 2
                input_size = (input_size[0] // 2, input_size[1] // 2)
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        x = self.patch_embed(x)
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.last:
                outs.append(getattr(self, f"scale{len(outs) + 2}_norm")(x))
        return outs


def lka_decoders(dims: Sequence[int], num_classes: int):
    """decoder_3 … decoder_0 of the LKA Baseline's decoder over encoder
    maps of `dims` channels (/4 … /32)."""
    kw = dict(n_class=num_classes, deformable=False)
    return (DecoderLayer(dims[3], first=True, **kw), DecoderLayer(dims[2], **kw),
            DecoderLayer(dims[1], **kw), DecoderLayer(dims[0], is_last=True, **kw))


class MViTLKAFormer(nn.Module):
    """(B, H, W, 1 | 3) → logits (B, H, W, num_classes)."""

    jax_renames = ()

    def __init__(self, num_classes: int = 9, img_size: int = 224, embed_dim: int = 96,
                 depth: int = 16, last_block_indexes: Sequence[int] = (0, 2, 11, 15)):
        super().__init__()
        self.backbone = MViT4Out(img_size, embed_dim, depth, last_block_indexes)
        d = embed_dim
        self.decoder_3, self.decoder_2, self.decoder_1, self.decoder_0 = lka_decoders(
            (d, 2 * d, 4 * d, 8 * d), num_classes)

    def forward(self, x):
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        e0, e1, e2, e3 = self.backbone(x)
        t = self.decoder_2(self.decoder_3(e3), e2)
        return self.decoder_0(self.decoder_1(t, e1), e0)
