"""HiFormer: a CNN and Swin pyramid with CrossViT-style dual-level fusion,
a skin baseline.

Port of `deformablelka_tpu/models/hiformer.py` (upstream's
`2D/skin_code/model/hiformer/`), channels-last, with upstream's torch
attribute names:

    PyramidFeatures: torchvision resnet34's stem and layers 1-3
        interleaved with Swin-tiny stages (96, 192, 384), fused by
        addition of 1×1 projections, patch merging between levels; CLS
        tokens are the token mean of the LayerNormed level-1 and level-3
        maps;
    All2Cross: learned position embeddings per branch, the fusion blocks,
        a LayerNorm per branch;
    MultiScaleBlock: each branch's CLS projected into the other branch,
        fused by CLS-query cross attention, projected back, re-attached to
        its own tokens, then the branch's ViT blocks. `reference_exact`
        reproduces the upstream file at its shipped configs (no fusion
        block, branch blocks dead); the default (False) is the published
        HiFormer with one fusion block per branch and live branch blocks;
    ConvUpsample towers (3×3 conv, GroupNorm(32), ReLU, ×2 bilinear on the
        small branch), their sum, a 1×1 conv to 16 + ReLU, ×4 bilinear, a
        3×3 head.

The Swin blocks and patch merging are `models/swinunet.py`'s.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from deformablelka_tpu_torch.models.swinunet import BasicLayer, PatchMerging
from deformablelka_tpu_torch.nn.layers import Conv2d, Linear
from deformablelka_tpu_torch.nn.norms import BatchNorm, GroupNorm, LayerNorm
from deformablelka_tpu_torch.nn.segformer import MLP_FFN, attend, resize_bilinear
from deformablelka_tpu_torch.ops.convs import to_nchw, to_nhwc


class BasicBlock(nn.Module):
    """torchvision's resnet BasicBlock."""

    jax_renames = (("down_conv", "downsample.0"), ("down_bn", "downsample.1"))

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, features, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(features)
        self.downsample = (nn.Sequential(Conv2d(cin, features, 1, stride=stride, padding=0,
                                                bias=False), BatchNorm(features))
                           if stride != 1 or cin != features else None)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        return F.relu(h + (x if self.downsample is None else self.downsample(x)))


class ResNetLayer(nn.Sequential):
    jax_renames = ((r"block(\d+)", r"\1"),)

    def __init__(self, cin: int, features: int, blocks: int, stride: int = 1):
        super().__init__(*(BasicBlock(cin if i == 0 else features, features,
                                      stride if i == 0 else 1) for i in range(blocks)))


class ViTBlock(nn.Module):
    """timm's Block: pre-norm multi-head attention and MLP."""

    jax_renames = ((r"(qkv|proj)", r"attn.\1"), (r"fc(\d)", r"mlp.fc\1"))

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = LayerNorm(dim)
        self.attn = nn.Module()
        self.attn.qkv = Linear(dim, 3 * dim)
        self.attn.proj = Linear(dim, dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLP_FFN(dim, int(dim * mlp_ratio))

    def forward(self, x):
        B, N, C = x.shape
        h = self.num_heads
        qkv = self.attn.qkv(self.norm1(x)).reshape(B, N, 3, h, C // h).permute(2, 0, 3, 1, 4)
        o = attend(qkv[0], qkv[1], qkv[2], (C // h) ** -0.5)
        x = x + self.attn.proj(o.transpose(1, 2).reshape(B, N, C))
        return x + self.mlp(self.norm2(x))


class CrossAttentionBlock(nn.Module):
    """The CLS token queries all tokens; returns the fused CLS (B, 1, C)."""

    jax_renames = ((r"(wq|wk|wv|proj)", r"attn.\1"),)

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = LayerNorm(dim)
        self.attn = nn.Module()
        for n in ("wq", "wk", "wv", "proj"):
            setattr(self.attn, n, Linear(dim, dim))

    def forward(self, x):
        B, N, C = x.shape
        h = self.num_heads
        n = self.norm1(x)
        q = self.attn.wq(n[:, :1]).reshape(B, 1, h, C // h).transpose(1, 2)
        k = self.attn.wk(n).reshape(B, N, h, C // h).transpose(1, 2)
        v = self.attn.wv(n).reshape(B, N, h, C // h).transpose(1, 2)
        o = attend(q, k, v, (C // h) ** -0.5).transpose(1, 2).reshape(B, 1, C)
        return x[:, :1] + self.attn.proj(o)


def _proj(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(LayerNorm(cin), nn.GELU(), Linear(cin, cout))


class MultiScaleBlock(nn.Module):
    """CrossViT's dual-branch fusion (see the module docstring)."""

    def __init__(self, dims: Sequence[int] = (96, 384), depth: Sequence[int] = (1, 1, 0),
                 num_heads: Sequence[int] = (3, 3), mlp_ratio: Sequence[float] = (1.0, 1.0, 1.0),
                 reference_exact: bool = False):
        super().__init__()
        nb = len(dims)
        self.reference_exact = reference_exact
        other = lambda d: (d + 1) % nb
        self.projs = nn.ModuleList(_proj(dims[d], dims[other(d)]) for d in range(nb))
        self.revert_projs = nn.ModuleList(_proj(dims[other(d)], dims[d]) for d in range(nb))
        n_fuse = depth[-1] if reference_exact else max(depth[-1], 1)
        if n_fuse:
            # CrossViT: one block per branch at depth[-1] = 0, else a Sequential
            fuse = lambda d: CrossAttentionBlock(dims[other(d)], num_heads[other(d)])
            self.fusion = nn.ModuleList(
                fuse(d) if depth[-1] == 0 else nn.Sequential(*(fuse(d) for _ in range(n_fuse)))
                for d in range(nb))
        else:
            self.fusion = None
        self.jax_renames = (
            (r"proj(\d)_norm", r"projs.\1.0"), (r"proj(\d)_linear", r"projs.\1.2"),
            (r"revert(\d)_norm", r"revert_projs.\1.0"),
            (r"revert(\d)_linear", r"revert_projs.\1.2"),
            (r"fusion(\d)_(\d+)", r"fusion.\1" if depth[-1] == 0 else r"fusion.\1.\2"),
            (r"block(\d)_(\d+)", r"blocks.\1.\2"))
        self.blocks = None if reference_exact else nn.ModuleList(
            nn.ModuleList(ViTBlock(dims[d], num_heads[d], mlp_ratio[d]) for _ in range(depth[d]))
            for d in range(nb))

    def forward(self, xs):
        nb = len(xs)
        cls = [self.projs[d](xs[d][:, :1]) for d in range(nb)]
        outs = []
        for d in range(nb):
            tmp = torch.cat([cls[d], xs[(d + 1) % nb][:, 1:]], 1)
            if self.fusion is not None:
                tmp = self.fusion[d](tmp)
            out = torch.cat([self.revert_projs[d](tmp[:, :1]), xs[d][:, 1:]], 1)
            if self.blocks is not None:
                for blk in self.blocks[d]:
                    out = blk(out)
            outs.append(out)
        return outs


class SwinTransformer(nn.Module):
    def __init__(self, dims, depths, heads, window_size):
        super().__init__()
        self.layers = nn.ModuleList(BasicLayer(d, h, n, window_size, False)
                                    for d, n, h in zip(dims, depths, heads))


class PyramidFeatures(nn.Module):
    """resnet34 + Swin-tiny additive pyramid: [CLS + 56² tokens of 96, CLS
    + 14² tokens of 384] at the default widths."""

    jax_renames = (("root_conv", "resnet_layers.0"), ("root_bn", "resnet_layers.1"),
                   (r"layer(\d)", lambda m: f"resnet_layers.{3 + int(m[1])}"),
                   (r"swin(\d)_(\d+)", r"swin_transformer.layers.\1.blocks.\2"))

    def __init__(self, img_size: int = 224, swin_dims: Sequence[int] = (96, 192, 384),
                 cnn_dims: Sequence[int] = (64, 128, 256), cnn_blocks: Sequence[int] = (3, 4, 6),
                 swin_depths: Sequence[int] = (2, 2, 6), swin_heads: Sequence[int] = (3, 6, 12),
                 window_size: int = 7):
        super().__init__()
        self.img_size = img_size
        s1, s2, s3 = swin_dims
        c1, c2, c3 = cnn_dims
        self.resnet_layers = nn.Sequential(
            Conv2d(3, 64, 7, stride=2, padding=3, bias=False), BatchNorm(64), nn.ReLU(),
            nn.MaxPool2d(3, 2, 1), ResNetLayer(64, c1, cnn_blocks[0]),
            ResNetLayer(c1, c2, cnn_blocks[1], 2), ResNetLayer(c2, c3, cnn_blocks[2], 2))
        self.swin_transformer = SwinTransformer(swin_dims, swin_depths, swin_heads, window_size)
        self.p1_ch = Conv2d(c1, s1, 1)
        self.p1_pm = PatchMerging(s1)
        self.norm_1 = LayerNorm(s1)
        self.p2_ch = Conv2d(c2, s2, 1)
        self.p2_pm = PatchMerging(s2)
        self.p3_ch = Conv2d(c3, s3, 1)
        self.norm_2 = LayerNorm(s3)

    def _swin(self, t, H, stage):
        for blk in self.swin_transformer.layers[stage].blocks:
            t = blk(t, H, H)
        return t

    def forward(self, x):
        r = self.resnet_layers
        h = F.relu(r[1](r[0](x)))
        h = to_nhwc(F.max_pool2d(to_nchw(h), 3, 2, 1))
        fm1 = r[4](h)
        B = fm1.shape[0]
        H1 = self.img_size // 4
        t = self.p1_ch(fm1).reshape(B, H1 * H1, -1)
        sw1_skipped = t + self._swin(t, H1, 0)
        cls1 = self.norm_1(sw1_skipped).mean(1, keepdim=True)
        t = self.p1_pm(sw1_skipped, H1, H1)
        H2 = H1 // 2
        t = self._swin(t, H2, 1)
        fm2 = r[5](fm1)
        t = self.p2_pm(t + self.p2_ch(fm2).reshape(B, H2 * H2, -1), H2, H2)
        H3 = H2 // 2
        t = self._swin(t, H3, 2)
        fm3 = r[6](fm2)
        t = t + self.p3_ch(fm3).reshape(B, H3 * H3, -1)
        cls3 = self.norm_2(t).mean(1, keepdim=True)
        return [torch.cat([cls1, sw1_skipped], 1), torch.cat([cls3, t], 1)]


class All2Cross(nn.Module):
    def __init__(self, img_size, swin_dims, cnn_dims, cnn_blocks, swin_depths, swin_heads,
                 dlf_depth, dlf_heads, dlf_mlp_ratio, n_dlf_blocks, reference_exact):
        super().__init__()
        dims = (swin_dims[0], swin_dims[2])
        self.pyramid = PyramidFeatures(img_size, swin_dims, cnn_dims, cnn_blocks,
                                       swin_depths, swin_heads)
        n = ((img_size // 4) ** 2, (img_size // 16) ** 2)
        self.pos_embed = nn.ParameterList(
            nn.Parameter(torch.empty(1, 1 + n[i], d)) for i, d in enumerate(dims))
        self.blocks = nn.ModuleList(
            MultiScaleBlock(dims, dlf_depth, dlf_heads, dlf_mlp_ratio, reference_exact)
            for _ in range(n_dlf_blocks))
        self.norm = nn.ModuleList(LayerNorm(d) for d in dims)

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            for p in self.pos_embed:
                p.normal_(0.0, 0.02, generator=generator)

    def forward(self, x):
        xs = [t + p for t, p in zip(self.pyramid(x), self.pos_embed)]
        for blk in self.blocks:
            xs = blk(xs)
        return [norm(t) for norm, t in zip(self.norm, xs)]


class _Upsample2x(nn.Module):
    def forward(self, x):
        return resize_bilinear(x, (2 * x.shape[1], 2 * x.shape[2]))


class ConvTower(nn.Sequential):
    """conv (3×3, no bias), GroupNorm(32), ReLU[, ×2 bilinear] per level;
    the JAX `conv{l}`/`gn{l}` are the entries 0 and 1 of level l."""

    def __init__(self, cin: int, out_chans: Sequence[int], upsample: bool):
        mods, step = [], 4 if upsample else 3
        for c in out_chans:
            mods += [Conv2d(cin, c, 3, bias=False), GroupNorm(32, c), nn.ReLU()]
            mods += [_Upsample2x()] if upsample else []
            cin = c
        super().__init__(*mods)
        self.jax_renames = ((r"conv(\d)", lambda m: str(step * int(m[1]))),
                            (r"gn(\d)", lambda m: str(step * int(m[1]) + 1)))


class ConvUpsample(nn.Module):
    def __init__(self, cin: int, out_chans: Sequence[int] = (128,), upsample: bool = True):
        super().__init__()
        self.convs_level = ConvTower(cin, out_chans, upsample)

    def forward(self, x):
        return self.convs_level(x)


class _Resize(nn.Module):
    def __init__(self, size: int):
        super().__init__()
        self.size = size

    def forward(self, x):
        return resize_bilinear(x, (self.size, self.size))


class HiFormer(nn.Module):
    """HiFormer-S. (B, H, W, 1 | 3) → logits (B, H, W, num_classes)."""

    jax_renames = (("pyramid", "All2Cross.pyramid"),
                   (r"pos_embed_(\d)", r"All2Cross.pos_embed.\1"),
                   (r"dlf(\d+)", r"All2Cross.blocks.\1"), (r"norm(\d)", r"All2Cross.norm.\1"),
                   ("convup_l", "ConvUp_l.convs_level"), ("convup_s", "ConvUp_s.convs_level"),
                   ("conv_pred", "conv_pred.0"), ("segmentation_head", "segmentation_head.0"))

    def __init__(self, num_classes: int = 9, img_size: int = 224,
                 swin_dims: Sequence[int] = (96, 192, 384),
                 cnn_dims: Sequence[int] = (64, 128, 256), cnn_blocks: Sequence[int] = (3, 4, 6),
                 swin_depths: Sequence[int] = (2, 2, 6), swin_heads: Sequence[int] = (3, 6, 12),
                 dlf_depth: Sequence[int] = (1, 1, 0), dlf_heads: Sequence[int] = (3, 3),
                 dlf_mlp_ratio: Sequence[float] = (1.0, 1.0, 1.0), n_dlf_blocks: int = 1,
                 reference_exact: bool = False):
        super().__init__()
        self.img_size = img_size
        self.dims = (swin_dims[0], swin_dims[2])
        self.All2Cross = All2Cross(img_size, swin_dims, cnn_dims, cnn_blocks, swin_depths,
                                   swin_heads, dlf_depth, dlf_heads, dlf_mlp_ratio,
                                   n_dlf_blocks, reference_exact)
        self.ConvUp_l = ConvUpsample(self.dims[0], (128,), upsample=False)
        self.ConvUp_s = ConvUpsample(self.dims[1], (128, 128), upsample=True)
        self.conv_pred = nn.Sequential(Conv2d(128, 16, 1), nn.ReLU(), _Resize(img_size))
        self.segmentation_head = nn.Sequential(Conv2d(16, num_classes, 3))

    def forward(self, x):
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        B = x.shape[0]
        xs = self.All2Cross(x)
        H1, H3 = self.img_size // 4, self.img_size // 16
        e_l = self.ConvUp_l(xs[0][:, 1:].reshape(B, H1, H1, self.dims[0]))
        e_s = self.ConvUp_s(xs[1][:, 1:].reshape(B, H3, H3, self.dims[1]))
        return self.segmentation_head(self.conv_pred(e_l + e_s))
