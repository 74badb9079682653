"""TransUNet (the TransNorm variant): the R50-ViT-B/16 hybrid, a skin
baseline.

Port of `deformablelka_tpu/models/transunet.py` (upstream's
`2D/skin_code/model/vit_seg_modeling.py` and
`vit_seg_modeling_resnet_skip.py`), channels-last, with upstream's torch
attribute names:

    ResNetV2: weight-standardised convs (`StdConv2d`, var + 1e-5),
        bottlenecks with GroupNorm(32, eps 1e-6), a 7×7/2 root and a 3/2
        max pool without padding; its /4 map zero-padded to 56²; skips
        deepest first;
    the ViT: a 1×1 patch embedding to 768, learned position embeddings, 12
        blocks whose attention also carries a "spatial" stream
        (probabilities · a fourth projection); the last block's stream
        gates the decoder;
    DecoderCup: conv_more and conv_att (3×3 conv, batch norm, ReLU) to
        512, four decoder blocks (×2 bilinear with align_corners of both
        streams, skip concat, a channel-attention gate, two 3×3 conv-BN-
        ReLU, times the gate stream), a 3×3 head.

The registry builds it with `apply_sigmoid=False`: logits out.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from deformablelka_tpu_torch.nn.layers import Conv2d, Linear
from deformablelka_tpu_torch.nn.norms import BatchNorm, GroupNorm, LayerNorm
from deformablelka_tpu_torch.nn.segformer import MLP_FFN
from deformablelka_tpu_torch.ops import convs as C
from deformablelka_tpu_torch.ops.convs import to_nchw, to_nhwc


def upsample_bilinear2x(x, scale: int = 2):
    """torch's `UpsamplingBilinear2d(scale_factor=scale)` (align_corners)
    of an NHWC map."""
    return to_nhwc(F.interpolate(to_nchw(x), scale_factor=scale, mode="bilinear",
                                 align_corners=True))


class StdConv2d(Conv2d):
    """A conv whose weight is standardised per output channel over (Cin,
    kh, kw): (w − mean) / sqrt(var + 1e-5); padding k // 2."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, stride: int = 1,
                 bias: bool = False):
        super().__init__(cin, cout, kernel_size, stride=stride, padding=kernel_size // 2,
                         bias=bias)

    def forward(self, x):
        w = self.weight
        mean = w.mean((1, 2, 3), keepdim=True)
        var = w.var((1, 2, 3), keepdim=True, unbiased=False)
        w = (w - mean) / torch.sqrt(var + 1e-5)
        return C.conv2d(x, w, self.bias, stride=self.stride, padding=self.padding)


class PreActBottleneck(nn.Module):
    def __init__(self, cin: int, cout: int, cmid: int, stride: int = 1):
        super().__init__()
        self.gn1 = GroupNorm(32, cmid, eps=1e-6)
        self.conv1 = StdConv2d(cin, cmid, 1)
        self.gn2 = GroupNorm(32, cmid, eps=1e-6)
        self.conv2 = StdConv2d(cmid, cmid, 3, stride)
        self.gn3 = GroupNorm(32, cout, eps=1e-6)
        self.conv3 = StdConv2d(cmid, cout, 1)
        if stride != 1 or cin != cout:
            self.downsample = StdConv2d(cin, cout, 1, stride)
            self.gn_proj = GroupNorm(cout, cout)
        else:
            self.downsample = None

    def forward(self, x):
        residual = x if self.downsample is None else self.gn_proj(self.downsample(x))
        y = F.relu(self.gn1(self.conv1(x)))
        y = F.relu(self.gn2(self.conv2(y)))
        return F.relu(residual + self.gn3(self.conv3(y)))


class ResNetV2(nn.Module):
    """The R50 root and 3 stages; returns (the /16 map, skips deepest
    first)."""

    jax_renames = (("root_conv", "root.conv"), ("root_gn", "root.gn"),
                   (r"block(\d)_unit(\d+)", r"body.block\1.unit\2"))

    def __init__(self, block_units: Sequence[int] = (3, 4, 9), width_factor: int = 1):
        super().__init__()
        width = int(64 * width_factor)
        self.root = nn.Sequential()
        self.root.add_module("conv", StdConv2d(3, width, 7, 2))
        self.root.add_module("gn", GroupNorm(32, width, eps=1e-6))
        self.body = nn.Sequential()
        cin = width
        for b, (cout, cmid, n) in enumerate(zip((4 * width, 8 * width, 16 * width),
                                                (width, 2 * width, 4 * width), block_units)):
            block = nn.Sequential()
            for u in range(n):
                block.add_module(f"unit{u + 1}", PreActBottleneck(
                    cin, cout, cmid, 2 if (u == 0 and b > 0) else 1))
                cin = cout
            self.body.add_module(f"block{b + 1}", block)

    def forward(self, x):
        x = F.relu(self.root.gn(self.root.conv(x)))
        feats = [x]
        in_size = 2 * x.shape[1]
        x = to_nhwc(F.max_pool2d(to_nchw(x), 3, 2))
        for b, block in enumerate(self.body):
            x = block(x)
            if b < 2:
                right = in_size // 4 // (b + 1)
                pad = right - x.shape[1]
                feats.append(F.pad(x, (0, 0, 0, pad, 0, pad)) if pad else x)
        return x, feats[::-1]


class Attention(nn.Module):
    """Multi-head attention and the TransNorm spatial stream."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = Linear(hidden, hidden)
        self.key = Linear(hidden, hidden)
        self.value = Linear(hidden, hidden)
        self.spatial = Linear(hidden, hidden)
        self.out = Linear(hidden, hidden)

    def forward(self, x):
        B, N, D = x.shape
        h = self.heads

        def split(t):
            return t.reshape(B, N, h, D // h).transpose(1, 2)

        q, k, v, s = (split(m(x)) for m in (self.query, self.key, self.value, self.spatial))
        probs = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(D // h), -1)
        merge = lambda t: torch.matmul(probs, t).transpose(1, 2).reshape(B, N, D)
        return self.out(merge(v)), merge(s)


class Block(nn.Module):
    """Pre-norm (eps 1e-6) attention and MLP; returns (x, spatial)."""

    jax_renames = ((r"fc(\d)", r"ffn.fc\1"),)

    def __init__(self, hidden: int, heads: int, mlp_dim: int):
        super().__init__()
        self.attention_norm = LayerNorm(hidden, eps=1e-6)
        self.attn = Attention(hidden, heads)
        self.ffn_norm = LayerNorm(hidden, eps=1e-6)
        self.ffn = MLP_FFN(hidden, mlp_dim)

    def forward(self, x):
        a, spatial = self.attn(self.attention_norm(x))
        x = x + a
        return x + self.ffn(self.ffn_norm(x)), spatial


class Conv2dReLU(nn.Sequential):
    """k×k conv (no bias), batch norm, ReLU."""

    jax_renames = (("conv", "0"), ("bn", "1"))

    def __init__(self, cin: int, cout: int, kernel_size: int = 3):
        super().__init__(Conv2d(cin, cout, kernel_size,
                                padding="same" if kernel_size > 1 else 0, bias=False),
                         BatchNorm(cout), nn.ReLU())


class ChannelAttention(nn.Module):
    """x · sigmoid(fc(avg-pooled x) + fc(max-pooled x)), fc a bias-free
    1×1 bottleneck (ratio 16) with ReLU."""

    jax_renames = (("fc1", "fc.0"), ("fc2", "fc.2"))

    def __init__(self, channels: int, ratio: int = 16):
        super().__init__()
        mid = max(channels // ratio, 1)
        self.fc = nn.Sequential(Conv2d(channels, mid, 1, bias=False), nn.ReLU(),
                                Conv2d(mid, channels, 1, bias=False))

    def forward(self, x):
        avg = x.mean((1, 2), keepdim=True)
        mx = x.amax((1, 2), keepdim=True)
        return torch.sigmoid(self.fc(avg) + self.fc(mx)) * x


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, skip: int, att_in: int, features: int):
        super().__init__()
        self.convatt = Conv2dReLU(att_in, features)
        self.chatt = ChannelAttention(cin + skip)
        self.conv1 = Conv2dReLU(cin + skip, features)
        self.conv2 = Conv2dReLU(features, features)

    def forward(self, x, skip=None, att=None):
        x = upsample_bilinear2x(x)
        att = self.convatt(upsample_bilinear2x(att))
        if skip is not None:
            x = torch.cat([x, skip], -1)
        x = self.conv2(self.conv1(self.chatt(x)))
        return x * att, att


class Embeddings(nn.Module):
    def __init__(self, n_patches: int, hidden: int, block_units, width_factor):
        super().__init__()
        self.hybrid_model = ResNetV2(block_units, width_factor)
        self.patch_embeddings = Conv2d(int(64 * width_factor) * 16, hidden, 1)
        self.position_embeddings = nn.Parameter(torch.zeros(1, n_patches, hidden))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.position_embeddings.zero_()


class Encoder(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_dim: int, num_layers: int):
        super().__init__()
        self.layer = nn.ModuleList(Block(hidden, heads, mlp_dim) for _ in range(num_layers))
        self.encoder_norm = LayerNorm(hidden, eps=1e-6)


class Transformer(nn.Module):
    def __init__(self, img_size, hidden, heads, mlp_dim, num_layers, block_units,
                 width_factor):
        super().__init__()
        self.embeddings = Embeddings((img_size // 16) ** 2, hidden, block_units, width_factor)
        self.encoder = Encoder(hidden, heads, mlp_dim, num_layers)


class DecoderCup(nn.Module):
    def __init__(self, hidden: int, decoder_channels: Sequence[int], skip_channels):
        super().__init__()
        self.conv_more = Conv2dReLU(hidden, 512)
        self.conv_att = Conv2dReLU(hidden, 512)
        ins = (512,) + tuple(decoder_channels[:-1])
        self.blocks = nn.ModuleList(DecoderBlock(i, s, i, o) for i, s, o in
                                    zip(ins, skip_channels, decoder_channels))


class TransUNet(nn.Module):
    """(B, H, W, 1 | 3) → sigmoid probabilities, or logits when
    `apply_sigmoid` is False, (B, H, W, num_classes)."""

    jax_renames = (("hybrid_model", "transformer.embeddings.hybrid_model"),
                   ("patch_embeddings", "transformer.embeddings.patch_embeddings"),
                   ("position_embeddings", "transformer.embeddings.position_embeddings"),
                   (r"block(\d+)", r"transformer.encoder.layer.\1"),
                   ("encoder_norm", "transformer.encoder.encoder_norm"),
                   (r"(conv_more|conv_att)", r"decoder.\1"),
                   (r"decoder(\d)", r"decoder.blocks.\1"),
                   ("segmentation_head", "segmentation_head.0"))

    def __init__(self, num_classes: int = 1, img_size: int = 224, hidden: int = 768,
                 num_layers: int = 12, heads: int = 12, mlp_dim: int = 3072,
                 decoder_channels: Sequence[int] = (256, 128, 64, 16), n_skip: int = 3,
                 block_units: Sequence[int] = (3, 4, 9), width_factor: int = 1,
                 apply_sigmoid: bool = True):
        super().__init__()
        self.apply_sigmoid, self.n_skip = apply_sigmoid, n_skip
        width = int(64 * width_factor)
        skips = [8 * width, 4 * width, width, 0][:n_skip] + [0] * (4 - n_skip)
        self.transformer = Transformer(img_size, hidden, heads, mlp_dim, num_layers,
                                       block_units, width_factor)
        self.decoder = DecoderCup(hidden, decoder_channels, skips)
        self.segmentation_head = nn.Sequential(
            Conv2d(decoder_channels[-1], num_classes, 3))

    def forward(self, x):
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        emb = self.transformer.embeddings
        feat, skips = emb.hybrid_model(x)
        h16 = feat.shape[1]
        t = emb.patch_embeddings(feat)
        B, D = t.shape[0], t.shape[-1]
        t = t.reshape(B, h16 * h16, D) + emb.position_embeddings
        for blk in self.transformer.encoder.layer:
            t, spatial = blk(t)
        t = self.transformer.encoder.encoder_norm(t)
        dec = self.decoder
        xm = dec.conv_more(t.reshape(B, h16, h16, D))
        xa = dec.conv_att(spatial.reshape(B, h16, h16, D))
        for i, block in enumerate(dec.blocks):
            xm, xa = block(xm, skips[i] if i < self.n_skip else None, xa)
        out = self.segmentation_head(xm)
        return torch.sigmoid(out) if self.apply_sigmoid else out
