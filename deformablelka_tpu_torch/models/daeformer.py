"""DAEFormer: the dual-attention (efficient + channel) transformer net.

Port of `deformablelka_tpu/models/daeformer.py` (upstream's
`2D/networks/DAEFormer.py`), channels-last, with upstream's torch
attribute names (the JAX names but `block1.0` for `block1_0`):

    EfficientAttention: linear attention, softmax over the keys' tokens
                        and the queries' channels, context = K·Vᵀ;
    ChannelAttention:   transpose attention over channels, L2-normalised
                        q and k, a learned temperature per head;
    DualTransformerBlock: efficient attention, MixFFN, channel attention,
                        MixFFN, each pre-norm and residual;
    CrossAttentionBlock: the skip fusion, k and q from the skip, v from
                        the decoder stream;
    MiT3, DecoderLayer, DAEFormer.

The decoder layer at the bottom (`decoder_2`) is its PatchExpand only;
upstream also builds its dead linear, attention and transformer blocks.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from deformablelka_tpu_torch.models.maxvit_dlka import FinalPatchExpand_X4, PatchExpand
from deformablelka_tpu_torch.nn.layers import Conv2d, Linear
from deformablelka_tpu_torch.nn.norms import LayerNorm
from deformablelka_tpu_torch.nn.segformer import (OverlapPatchEmbeddings, make_ffn,
                                                  map_to_tokens, tokens_to_map)


def _linear_attention(k, q, v, heads: int):
    """Per head of `heads` equal channel slices: softmax of k over the
    tokens, of q over the channels, then q·(kᵀ·v). k, q (B, N, Ck), v (B,
    N, Cv) → (B, N, Cv)."""
    outs = []
    for kh, qh, vh in zip(k.chunk(heads, -1), q.chunk(heads, -1), v.chunk(heads, -1)):
        context = torch.matmul(torch.softmax(kh, 1).transpose(1, 2), vh)
        outs.append(torch.matmul(torch.softmax(qh, -1), context))
    return torch.cat(outs, -1)


class EfficientAttention(nn.Module):
    """Linear attention on an NHWC map."""

    def __init__(self, in_channels: int, key_channels: int, value_channels: int,
                 head_count: int = 1):
        super().__init__()
        self.head_count, self.value_channels = head_count, value_channels
        self.keys = Conv2d(in_channels, key_channels, 1)
        self.queries = Conv2d(in_channels, key_channels, 1)
        self.values = Conv2d(in_channels, value_channels, 1)
        self.reprojection = Conv2d(value_channels, in_channels, 1)

    def forward(self, x):
        B, H, W, _ = x.shape
        out = _linear_attention(map_to_tokens(self.keys(x)), map_to_tokens(self.queries(x)),
                                map_to_tokens(self.values(x)), self.head_count)
        return self.reprojection(out.reshape(B, H, W, self.value_channels))


class ChannelAttention(nn.Module):
    """Transpose (channel) attention on tokens."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = Linear(dim, 3 * dim, bias=False)
        self.proj = Linear(dim, dim)

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.temperature.fill_(1.0)

    def forward(self, x):
        B, N, C = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, h, C // h).permute(2, 0, 3, 4, 1)
        q, k, v = qkv[0], qkv[1], qkv[2]                 # (B, h, C/h, N)
        q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
        k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-12)
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * self.temperature, -1)
        out = torch.matmul(attn, v).permute(0, 3, 1, 2).reshape(B, N, C)
        return self.proj(out)


class DualTransformerBlock(nn.Module):
    def __init__(self, in_dim: int, key_dim: int, value_dim: int, head_count: int = 1,
                 token_mlp: str = "mix_skip"):
        super().__init__()
        self.norm1 = LayerNorm(in_dim)
        self.attn = EfficientAttention(in_dim, key_dim, value_dim, head_count)
        self.norm2 = LayerNorm(in_dim)
        self.mlp1 = make_ffn(token_mlp, in_dim, 4 * in_dim)
        self.norm3 = LayerNorm(in_dim)
        self.channel_attn = ChannelAttention(in_dim)
        self.norm4 = LayerNorm(in_dim)
        self.mlp2 = make_ffn(token_mlp, in_dim, 4 * in_dim)

    def forward(self, x, H, W):
        x = x + map_to_tokens(self.attn(tokens_to_map(self.norm1(x), H, W)))
        x = x + self.mlp1(self.norm2(x), H, W)
        x = x + self.channel_attn(self.norm3(x))
        return x + self.mlp2(self.norm4(x), H, W)


class CrossAttention(nn.Module):
    """k and q from the skip x2, v from x1; the D-channel result mapped to
    2·value_channels and normalised."""

    def __init__(self, in_dim: int, key_channels: int, value_channels: int,
                 head_count: int = 1):
        super().__init__()
        self.head_count = head_count
        self.reprojection = Conv2d(in_dim, 2 * value_channels, 1)
        self.norm = LayerNorm(2 * value_channels)

    def forward(self, x1, x2, H, W):
        B, N, D = x1.shape
        out = _linear_attention(x2, x2, x1, self.head_count)
        return self.norm(map_to_tokens(self.reprojection(out.reshape(B, H, W, D))))


class CrossAttentionBlock(nn.Module):
    def __init__(self, in_dim: int, key_dim: int, value_dim: int, head_count: int = 1,
                 token_mlp: str = "mix_skip"):
        super().__init__()
        self.norm1 = LayerNorm(in_dim)
        self.attn = CrossAttention(in_dim, key_dim, value_dim, head_count)
        self.norm2 = LayerNorm(2 * in_dim)
        self.mlp = make_ffn(token_mlp, 2 * in_dim, 4 * in_dim)

    def forward(self, x1, x2, H, W):
        tx = torch.cat([x1, x2], -1) + self.attn(self.norm1(x1), self.norm1(x2), H, W)
        return tx + self.mlp(self.norm2(tx), H, W)


class MiT3(nn.Module):
    """The 3-stage dual-attention encoder; returns 3 NHWC maps (/4, /8,
    /16)."""

    jax_renames = ((r"block(\d)_(\d+)", r"block\1.\2"),)

    def __init__(self, dims: Sequence[int] = (128, 320, 512),
                 layers: Sequence[int] = (2, 2, 2), head_count: int = 1,
                 token_mlp: str = "mix_skip"):
        super().__init__()
        patch, strides, pads = (7, 3, 3), (4, 2, 2), (3, 1, 1)
        cin = 3
        for s in range(3):
            d = dims[s]
            setattr(self, f"patch_embed{s + 1}", OverlapPatchEmbeddings(
                patch[s], strides[s], pads[s], cin, d))
            setattr(self, f"block{s + 1}", nn.ModuleList(
                DualTransformerBlock(d, d, d, head_count, token_mlp)
                for _ in range(layers[s])))
            setattr(self, f"norm{s + 1}", LayerNorm(d))
            cin = d

    def forward(self, x):
        outs = []
        for s in range(1, 4):
            t, H, W = getattr(self, f"patch_embed{s}")(x)
            for blk in getattr(self, f"block{s}"):
                t = blk(t, H, W)
            x = tokens_to_map(getattr(self, f"norm{s}")(t), H, W)
            outs.append(x)
        return outs


class DecoderLayer(nn.Module):
    """upstream's MyDecoderLayer. `first` (x2 absent) is a PatchExpand of
    its map; the others take x1 (tokens or a map of `x1_dim` channels) and
    the skip map x2 of `dims` channels (twice that on the last), fuse them
    by cross attention, run two dual-transformer blocks at `out_dim` and
    expand (×4 and a 1×1 class head on the last). Returns tokens, or the
    logits map on the last."""

    def __init__(self, dims: int, out_dim: int, key_dim: int, value_dim: int,
                 x1_dim: int, n_class: int = 9, head_count: int = 1,
                 token_mlp: str = "mix_skip", is_last: bool = False, first: bool = False):
        super().__init__()
        self.first, self.is_last, self.out_dim = first, is_last, out_dim
        if first:
            self.layer_up = PatchExpand(out_dim)
            return
        ca_dim = 2 * dims if is_last else dims
        self.x1_linear = Linear(x1_dim, out_dim)
        self.cross_attn = CrossAttentionBlock(ca_dim, key_dim, value_dim, head_count,
                                              token_mlp)
        self.concat_linear = Linear(2 * ca_dim, out_dim)
        self.layer_former_1 = DualTransformerBlock(out_dim, key_dim, value_dim,
                                                   head_count, token_mlp)
        self.layer_former_2 = DualTransformerBlock(out_dim, key_dim, value_dim,
                                                   head_count, token_mlp)
        if is_last:
            self.layer_up = FinalPatchExpand_X4(out_dim)
            self.last_layer = Conv2d(out_dim, n_class, 1)
        else:
            self.layer_up = PatchExpand(out_dim)

    def forward(self, x1, x2=None):
        if self.first:
            return self.layer_up(x1)
        B, H, W, _ = x2.shape
        x1e = self.x1_linear(x1).reshape(B, H * W, self.out_dim)
        t = self.concat_linear(self.cross_attn(x1e, map_to_tokens(x2), H, W))
        t = self.layer_former_2(self.layer_former_1(t, H, W), H, W)
        m = self.layer_up(t.reshape(B, H, W, self.out_dim))
        return self.last_layer(m) if self.is_last else map_to_tokens(m)


def dae_decoders(dims: Sequence[int], num_classes: int, head_count: int = 1,
                 token_mlp: str = "mix_skip"):
    """decoder_2, decoder_1, decoder_0 of DAEFormer's decoder over encoder
    maps of `dims` channels (/4, /8, /16)."""
    d0, d1, d2 = dims
    kw = dict(n_class=num_classes, head_count=head_count, token_mlp=token_mlp)
    return (DecoderLayer(d2, d2, d2, d2, d2, first=True, **kw),
            DecoderLayer(d1, d1, d1, d1, d2 // 2, **kw),
            DecoderLayer(d0 // 2, d0, d0, d0, d1 // 2, is_last=True, **kw))


class DAEFormer(nn.Module):
    """(B, H, W, 1 | 3) → logits (B, H, W, num_classes)."""

    jax_renames = ()

    def __init__(self, num_classes: int = 9, head_count: int = 1,
                 token_mlp: str = "mix_skip", dims: Sequence[int] = (128, 320, 512),
                 layers: Sequence[int] = (2, 2, 2)):
        super().__init__()
        self.backbone = MiT3(dims, layers, head_count, token_mlp)
        self.decoder_2, self.decoder_1, self.decoder_0 = dae_decoders(
            dims, num_classes, head_count, token_mlp)

    def forward(self, x):
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        e0, e1, e2 = self.backbone(x)
        t2 = self.decoder_2(e2)
        return self.decoder_0(self.decoder_1(t2, e1), e0)
