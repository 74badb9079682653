"""SegFormer's layers, the MiT encoder and the SegFormer net, channels-last.

Port of `deformablelka_tpu/nn/segformer.py` (upstream's
`2D/networks/segformer.py`), with upstream's torch attribute names.
Tokens are (B, N, C); every spatial op goes through the (B, H, W, C) map.
`MixFFN_skip` keeps only the `norm1` it calls (upstream also builds a dead
`norm2` and `norm3`); `SegFormer`'s decode head has no `conv_seg` (never
called upstream).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from deformablelka_tpu_torch.nn.layers import Conv2d, Linear, gelu
from deformablelka_tpu_torch.nn.norms import BatchNorm, LayerNorm
from deformablelka_tpu_torch.ops.convs import to_nchw, to_nhwc


def tokens_to_map(x, H, W):
    B, N, C = x.shape
    return x.reshape(B, H, W, C)


def map_to_tokens(x):
    B, H, W, C = x.shape
    return x.reshape(B, H * W, C)


def attend(q, k, v, scale, bias=None):
    """softmax(q·kᵀ·scale + bias)·v over the last two axes, softmax in
    float32."""
    attn = torch.matmul(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        attn = attn + bias
    return torch.matmul(torch.softmax(attn.float(), -1).to(v.dtype), v)


def resize_bilinear(x, size):
    """`jax.image.resize(x, (B, *size, C), "bilinear")` of an NHWC map to a
    larger `size`: half-pixel centres, edges clamped (torch's
    align_corners=False)."""
    return to_nhwc(F.interpolate(to_nchw(x), size=tuple(size), mode="bilinear",
                                 align_corners=False))


def _heads(t, B, N, h):
    """(B, N, C) → (B, h, N, C // h)."""
    return t.reshape(B, N, h, -1).transpose(1, 2)


def _merge(o):
    """(B, h, N, c) → (B, N, h·c)."""
    B, h, N, c = o.shape
    return o.transpose(1, 2).reshape(B, N, h * c)


class EfficientSelfAtten(nn.Module):
    """q from the tokens, k and v from a `reduction_ratio`-strided conv of
    the map and a LayerNorm (none at ratio 1)."""

    def __init__(self, dim: int, head: int, reduction_ratio: int = 1):
        super().__init__()
        self.head, self.reduction_ratio = head, reduction_ratio
        self.q = Linear(dim, dim)
        self.kv = Linear(dim, 2 * dim)
        self.proj = Linear(dim, dim)
        if reduction_ratio > 1:
            self.sr = Conv2d(dim, dim, reduction_ratio, stride=reduction_ratio, padding=0)
            self.norm = LayerNorm(dim)

    def forward(self, x, H, W):
        B, N, C = x.shape
        h = self.head
        q = _heads(self.q(x), B, N, h)
        kv_in = x
        if self.reduction_ratio > 1:
            kv_in = self.norm(map_to_tokens(self.sr(tokens_to_map(x, H, W))))
        M = kv_in.shape[1]
        kv = self.kv(kv_in).reshape(B, M, 2, h, C // h).permute(2, 0, 3, 1, 4)
        out = attend(q, kv[0], kv[1], (C // h) ** -0.5)
        return self.proj(_merge(out))


class SelfAtten(nn.Module):
    def __init__(self, dim: int, head: int):
        super().__init__()
        self.head = head
        self.q = Linear(dim, dim)
        self.kv = Linear(dim, 2 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        h = self.head
        q = _heads(self.q(x), B, N, h)
        kv = self.kv(x).reshape(B, N, 2, h, C // h).permute(2, 0, 3, 1, 4)
        return self.proj(_merge(attend(q, kv[0], kv[1], (C // h) ** -0.5)))


class ScaleReduce(nn.Module):
    """Scale_reduce of the 4-scale bridge: the token segments are the four
    stage maps flattened with their channels folded to `dim`; scales 0-2
    are conv-downsampled by their reduction ratio before k and v."""

    def __init__(self, dim: int, reduction_ratio: Sequence[int] = (1, 2, 4, 8),
                 spatial: Sequence[int] = (56, 28, 14, 7),
                 folds: Sequence[int] = (1, 2, 5, 8)):
        super().__init__()
        self.spatial, self.folds = tuple(spatial), tuple(folds)
        rr = list(reduction_ratio)
        for i, fold in enumerate(self.folds[:-1]):
            r = rr[len(rr) - 1 - i]
            setattr(self, f"sr{i}", Conv2d(dim * fold, dim * fold, r, stride=r, padding=0))
        self.norm = LayerNorm(dim)

    def forward(self, x):
        B, N, C = x.shape
        pieces, start = [], 0
        for i, (hw, fold) in enumerate(zip(self.spatial, self.folds)):
            n_i = hw * hw * fold
            seg = x[:, start:start + n_i]
            start += n_i
            if i < len(self.spatial) - 1:
                m = getattr(self, f"sr{i}")(seg.reshape(B, hw, hw, C * fold))
                seg = m.reshape(B, -1, C)
            pieces.append(seg)
        return self.norm(torch.cat(pieces, 1))


class MEfficientSelfAtten(nn.Module):
    """Bridge attention with multi-scale k/v reduction."""

    def __init__(self, dim: int, head: int, reduction_ratio=(1, 2, 4, 8),
                 spatial=(56, 28, 14, 7), folds=(1, 2, 5, 8)):
        super().__init__()
        self.head = head
        self.q = Linear(dim, dim)
        self.scale_reduce = ScaleReduce(dim, reduction_ratio, spatial, folds)
        self.kv = Linear(dim, 2 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        h = self.head
        q = _heads(self.q(x), B, N, h)
        kv_in = self.scale_reduce(x)
        M = kv_in.shape[1]
        kv = self.kv(kv_in).reshape(B, M, 2, h, C // h).permute(2, 0, 3, 1, 4)
        return self.proj(_merge(attend(q, kv[0], kv[1], (C // h) ** -0.5)))


class DWConv(nn.Module):
    """3×3 depthwise conv of the token map."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x, H, W):
        return map_to_tokens(self.dwconv(tokens_to_map(x, H, W)))


class MixFFN(nn.Module):
    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.fc1 = Linear(c1, c2)
        self.dwconv = DWConv(c2)
        self.fc2 = Linear(c2, c1)

    def forward(self, x, H, W):
        return self.fc2(gelu(self.dwconv(self.fc1(x), H, W)))


class MixFFN_skip(nn.Module):
    """MixFFN with the skip and a LayerNorm inside."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.fc1 = Linear(c1, c2)
        self.dwconv = DWConv(c2)
        self.norm1 = LayerNorm(c2)
        self.fc2 = Linear(c2, c1)

    def forward(self, x, H, W):
        h = self.fc1(x)
        return self.fc2(gelu(self.norm1(self.dwconv(h, H, W) + h)))


class MLP_FFN(nn.Module):
    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.fc1 = Linear(c1, c2)
        self.fc2 = Linear(c2, c1)

    def forward(self, x, H=None, W=None):
        return self.fc2(gelu(self.fc1(x)))


def make_ffn(token_mlp: str, c1: int, c2: int) -> nn.Module:
    """The FFN of `token_mlp`: "mix", "mix_skip" or else the plain MLP.
    Each takes (tokens, H, W)."""
    if token_mlp == "mix":
        return MixFFN(c1, c2)
    if token_mlp == "mix_skip":
        return MixFFN_skip(c1, c2)
    return MLP_FFN(c1, c2)


class OverlapPatchEmbeddings(nn.Module):
    """A strided conv and a LayerNorm; returns (tokens, H, W)."""

    def __init__(self, patch_size: int = 7, stride: int = 4, padding: int = 3,
                 in_ch: int = 3, dim: int = 768):
        super().__init__()
        self.proj = Conv2d(in_ch, dim, patch_size, stride=stride, padding=padding)
        self.norm = LayerNorm(dim)

    def forward(self, x):
        m = self.proj(x)
        B, H, W, C = m.shape
        return self.norm(m.reshape(B, H * W, C)), H, W


class SegFormerBlock(nn.Module):
    """upstream segformer.py's TransformerBlock."""

    def __init__(self, dim: int, head: int, reduction_ratio: int = 1,
                 token_mlp: str = "mix_skip"):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = EfficientSelfAtten(dim, head, reduction_ratio)
        self.norm2 = LayerNorm(dim)
        self.mlp = make_ffn(token_mlp, dim, 4 * dim)

    def forward(self, x, H, W):
        x = x + self.attn(self.norm1(x), H, W)
        return x + self.mlp(self.norm2(x), H, W)


class MiT(nn.Module):
    """Mix-Transformer encoder: 4 stages of overlapping patch embedding and
    SegFormer blocks; returns the 4 NHWC maps (/4, /8, /16, /32)."""

    jax_renames = ((r"block(\d)_(\d+)", r"block\1.\2"),)

    def __init__(self, dims: Sequence[int] = (64, 128, 320, 512),
                 layers: Sequence[int] = (2, 2, 2, 2), token_mlp: str = "mix_skip"):
        super().__init__()
        patch, strides, pads = (7, 3, 3, 3), (4, 2, 2, 2), (3, 1, 1, 1)
        rr, heads = (8, 4, 2, 1), (1, 2, 5, 8)
        cin = 3
        for s in range(4):
            setattr(self, f"patch_embed{s + 1}", OverlapPatchEmbeddings(
                patch[s], strides[s], pads[s], cin, dims[s]))
            setattr(self, f"block{s + 1}", nn.ModuleList(
                SegFormerBlock(dims[s], heads[s], rr[s], token_mlp)
                for _ in range(layers[s])))
            setattr(self, f"norm{s + 1}", LayerNorm(dims[s]))
            cin = dims[s]

    def forward(self, x):
        outs = []
        for s in range(1, 5):
            t, H, W = getattr(self, f"patch_embed{s}")(x)
            for blk in getattr(self, f"block{s}"):
                t = blk(t, H, W)
            x = tokens_to_map(getattr(self, f"norm{s}")(t), H, W)
            outs.append(x)
        return outs


class MLP(nn.Module):
    """The decode head's per-scale linear embedding."""

    def __init__(self, dim: int, embed_dim: int):
        super().__init__()
        self.proj = Linear(dim, embed_dim)

    def forward(self, x):
        return self.proj(x)


class ConvModule(nn.Module):
    """1×1 conv (no bias), batch norm (eval statistics), ReLU."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.conv = Conv2d(c1, c2, 1, bias=False)
        self.bn = BatchNorm(c2)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class Decoder(nn.Module):
    """The all-MLP decode head: each scale embedded to `embed_dim`,
    upsampled to /4, concatenated deepest first, fused, classified."""

    def __init__(self, dims: Sequence[int], embed_dim: int, num_classes: int):
        super().__init__()
        for i, d in enumerate(dims):
            setattr(self, f"linear_c{i + 1}", MLP(d, embed_dim))
        self.linear_fuse = ConvModule(len(dims) * embed_dim, embed_dim)
        self.linear_pred = Conv2d(embed_dim, num_classes, 1)
        self.n = len(dims)

    def forward(self, feats):
        H0, W0 = feats[0].shape[1:3]
        ups = []
        for i, f in enumerate(feats):
            m = getattr(self, f"linear_c{i + 1}")(f)
            if m.shape[1:3] != (H0, W0):
                m = resize_bilinear(m, (H0, W0))
            ups.append(m)
        return self.linear_pred(self.linear_fuse(torch.cat(ups[::-1], -1)))


class SegFormer(nn.Module):
    """MiT encoder and the all-MLP decode head. (B, H, W, 1 | 3) → logits
    (B, H, W, num_classes): upstream's forward returns them at /4, and, as
    the JAX package's default (`upsample_to_input`), a bilinear ×4 brings
    them to the input's size."""

    jax_renames = ((r"linear_c(\d)", r"decode_head.linear_c\1.proj"),
                   ("linear_fuse", "decode_head.linear_fuse.conv"),
                   ("bn", "decode_head.linear_fuse.bn"),
                   ("linear_pred", "decode_head.linear_pred"))

    def __init__(self, num_classes: int = 9, dims: Sequence[int] = (64, 128, 320, 512),
                 layers: Sequence[int] = (2, 2, 2, 2), embed_dim: int = 256):
        super().__init__()
        self.backbone = MiT(dims, layers)
        self.decode_head = Decoder(dims, embed_dim, num_classes)

    def forward(self, x):
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        return resize_bilinear(self.decode_head(self.backbone(x)), x.shape[1:3])
