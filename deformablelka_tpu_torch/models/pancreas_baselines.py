"""The NIH Pancreas baselines: VNet, the ResNet34 seg net and UNETR,
channels-last (B, D, H, W, C).

Port of `deformablelka_tpu/models/pancreas_baselines.py`. Upstream's
networks, as the JAX package re-derived them:
  3D/pancreas_code/networks/vnet.py:5-246 — VNet: additive-skip
    encoder/decoder, 5 levels, ConvBlock(n_stages × [3³ conv + norm +
    ReLU]), strided-conv downsample, deconv upsample, filters 16·2^level,
    1³ head (upstream's optional dropout, off by default, is not built:
    the models run in eval mode).
  3D/pancreas_code/networks/ResNet34.py:184-248 — a 3D resnet34 encoder
    (conv7³ s1 stem, BasicBlock stages [3,4,6,3] each stride 2, widths
    16·2^l, zero-init bn2 gamma) + the VNet decoder family with
    normalization='none'; the encoder's maxpool/avgpool are never called
    there and are not built.
  3D/pancreas_code/networks/unetr.py:22-230 — UNETR (MONAI 0.7): ViT
    (16³ perceptron patch embedding + learned position embedding), taps
    after blocks 4/7/10, UnetrPrUpBlock deconv chains for the skips,
    UnetrUpBlock decoder, 1³ head.

Attribute names are upstream's (`block_one.conv.0`, `resnet_encoder.
layer1.0.downsample.0`, `vit.blocks.0.mlp.linear1`, `encoder1.layer`,
…), so `state_dict()` converts with `deformablelka_tpu.convert.
torch_loader.convert_vnet`, `convert_resnet34` and `convert_unetr`; each
module's `jax_renames` maps the JAX package's names onto them
(`convert/jax_params.py`). The VNet family's deconvs are flax
`ConvTranspose` in the JAX package (`StrideConvTranspose` here, whose
JAX kernel is flipped); UNETR's are the repo's own MONAI-style
`ConvTranspose` (not flipped).

As in the JAX package: the ViT's MLP uses the tanh GELU (flax `nn.gelu`'s
default; upstream's MONAI block uses the exact one), batch norms read
their running statistics, and the attention is plain
matmul-softmax-matmul with the softmax in float32. No hand-written kernel runs here: the convolutions,
norms and GEMMs go to cuDNN and cuBLAS.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from deformablelka_tpu_torch.models.dat_lka import _trunc_normal_
from deformablelka_tpu_torch.nn.dynunet import UnetOutBlock, UnetResBlock
from deformablelka_tpu_torch.nn.layers import (
    Conv3d, ConvTranspose, Linear, StrideConvTranspose)
from deformablelka_tpu_torch.nn.norms import (
    BatchNorm, GroupNorm, InstanceNorm, LayerNorm)


def _norm(kind: str, channels: int):
    if kind == "batchnorm":
        return BatchNorm(channels)
    if kind == "groupnorm":
        return GroupNorm(16, channels)
    if kind == "instancenorm":
        # vnet.py/ResNet34.py use nn.InstanceNorm3d(n): affine=False
        return InstanceNorm(channels, affine=False)
    if kind == "none":
        return None
    raise ValueError(f"unknown normalization {kind!r}")


def _conv_norm_relu(conv: nn.Module, normalization: str, channels: int) -> list:
    norm = _norm(normalization, channels)
    return [conv] + ([norm] if norm is not None else []) + [nn.ReLU()]


class ConvBlock(nn.Module):
    """`n_stages` × [3³ conv, norm, ReLU] in one Sequential `conv`, as
    upstream's (a stage is 3 entries with a norm, 2 without)."""

    def __init__(self, n_stages: int, n_filters_in: int, n_filters_out: int,
                 normalization: str = "none"):
        super().__init__()
        ops = []
        for i in range(n_stages):
            ops += _conv_norm_relu(
                Conv3d(n_filters_in if i == 0 else n_filters_out, n_filters_out,
                       3, padding=1), normalization, n_filters_out)
        self.conv = nn.Sequential(*ops)
        step = len(ops) // n_stages
        self.jax_renames = tuple(
            (f"{kind}{i}", f"conv.{i * step + off}")
            for i in range(n_stages) for kind, off in (("conv", 0), ("norm", 1)))

    def forward(self, x):
        return self.conv(x)


class DownBlock(nn.Module):
    """Strided k = s conv (no padding), norm, ReLU."""

    jax_renames = (("conv", "conv.0"), ("norm", "conv.1"))

    def __init__(self, n_filters_in: int, n_filters_out: int, stride: int = 2,
                 normalization: str = "none"):
        super().__init__()
        self.conv = nn.Sequential(*_conv_norm_relu(
            Conv3d(n_filters_in, n_filters_out, stride, stride=stride,
                   padding=0), normalization, n_filters_out))

    def forward(self, x):
        return self.conv(x)


class UpBlock(nn.Module):
    """k = s transposed conv, norm, ReLU."""

    jax_renames = (("conv", "conv.0"), ("norm", "conv.1"))

    def __init__(self, n_filters_in: int, n_filters_out: int, stride: int = 2,
                 normalization: str = "none"):
        super().__init__()
        self.conv = nn.Sequential(*_conv_norm_relu(
            StrideConvTranspose(n_filters_in, n_filters_out, stride),
            normalization, n_filters_out))

    def forward(self, x):
        return self.conv(x)


class _VNetDecoder(nn.Module):
    """The additive-skip deconv decoder shared by VNet and the ResNet34
    seg net, from the bottleneck (16·nf channels) to the 1³ head."""

    def _build_decoder(self, n_classes, nf, normalization):
        self.block_five_up = UpBlock(nf * 16, nf * 8, 2, normalization)
        self.block_six = ConvBlock(3, nf * 8, nf * 8, normalization)
        self.block_six_up = UpBlock(nf * 8, nf * 4, 2, normalization)
        self.block_seven = ConvBlock(3, nf * 4, nf * 4, normalization)
        self.block_seven_up = UpBlock(nf * 4, nf * 2, 2, normalization)
        self.block_eight = ConvBlock(2, nf * 2, nf * 2, normalization)
        self.block_eight_up = UpBlock(nf * 2, nf, 2, normalization)
        self.block_nine = ConvBlock(1, nf, nf, normalization)
        self.out_conv = Conv3d(nf, n_classes, 1, padding=0)

    def decode(self, x1, x2, x3, x4, x5):
        x6 = self.block_six(self.block_five_up(x5) + x4)
        x7 = self.block_seven(self.block_six_up(x6) + x3)
        x8 = self.block_eight(self.block_seven_up(x7) + x2)
        x9 = self.block_nine(self.block_eight_up(x8) + x1)
        return self.out_conv(x9)


class VNet(_VNetDecoder):
    """vnet.py:144-246 (additive skips, filters 16·2^l)."""

    jax_renames = ()

    def __init__(self, n_channels: int = 1, n_classes: int = 2,
                 n_filters: int = 16, normalization: str = "instancenorm"):
        super().__init__()
        nf, nm = n_filters, normalization
        self.block_one = ConvBlock(1, n_channels, nf, nm)
        self.block_one_dw = DownBlock(nf, nf * 2, 2, nm)
        self.block_two = ConvBlock(2, nf * 2, nf * 2, nm)
        self.block_two_dw = DownBlock(nf * 2, nf * 4, 2, nm)
        self.block_three = ConvBlock(3, nf * 4, nf * 4, nm)
        self.block_three_dw = DownBlock(nf * 4, nf * 8, 2, nm)
        self.block_four = ConvBlock(3, nf * 8, nf * 8, nm)
        self.block_four_dw = DownBlock(nf * 8, nf * 16, 2, nm)
        self.block_five = ConvBlock(3, nf * 16, nf * 16, nm)
        self._build_decoder(n_classes, nf, nm)

    def forward(self, x):
        x1 = self.block_one(x)
        x2 = self.block_two(self.block_one_dw(x1))
        x3 = self.block_three(self.block_two_dw(x2))
        x4 = self.block_four(self.block_three_dw(x3))
        x5 = self.block_five(self.block_four_dw(x4))
        return self.decode(x1, x2, x3, x4, x5)


class BasicBlock3d(nn.Module):
    """3D torchvision-style BasicBlock (resnet.py:23-55): conv3³(s) → bn →
    relu → conv3³ → bn (gamma 0 at init) [+ 1³(s) conv + bn shortcut] →
    relu, with torch's padding 1."""

    jax_renames = (("downsample_conv", "downsample.0"),
                   ("downsample_bn", "downsample.1"))

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv3d(inplanes, planes, 3, stride=stride, padding=1,
                            bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv3d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                Conv3d(inplanes, planes, 1, stride=stride, padding=0, bias=False),
                BatchNorm(planes))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.bn2.weight.zero_()

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNet34Encoder3d(nn.Module):
    """resnet34() 3D encoder (resnet.py:99-223, width 1 → base 16): conv7³
    s1 p3 stem + 4 BasicBlock stages, every stage's first block stride 2.
    Returns the 5 feature maps the Resnet34 forward uses."""

    jax_renames = ((r"layer(\d)_(\d+)", r"layer\1.\2"),)

    def __init__(self, in_channels: int = 1, width: int = 1,
                 depths: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        base = 16 * width
        self.conv1 = Conv3d(in_channels, base, 7, stride=1, padding=3, bias=False)
        self.bn1 = BatchNorm(base)
        inplanes = base
        for li, n_blocks in enumerate(depths):
            planes = base * 2 ** (li + 1)
            blocks = []
            for bi in range(n_blocks):
                blocks.append(BasicBlock3d(inplanes, planes, 2 if bi == 0 else 1))
                inplanes = planes
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
        self.n_layers = len(depths)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        feats = [h]
        for li in range(self.n_layers):
            h = getattr(self, f"layer{li + 1}")(h)
            feats.append(h)
        return feats


class Resnet34Seg(_VNetDecoder):
    """The pancreas Resnet34 baseline (ResNet34.py:184-240): the resnet34
    3D encoder + the additive-skip deconv decoder with upstream's
    constructor default normalization='none'."""

    jax_renames = ()

    def __init__(self, n_channels: int = 1, n_classes: int = 2,
                 n_filters: int = 16, normalization: str = "none"):
        super().__init__()
        self.resnet_encoder = ResNet34Encoder3d(n_channels)
        self._build_decoder(n_classes, n_filters, normalization)

    def forward(self, x):
        return self.decode(*self.resnet_encoder(x))


# ---------------------------------------------------------------------------
# UNETR (unetr.py:22-230 / MONAI 0.7)
# ---------------------------------------------------------------------------

def _wrapped(module: nn.Module) -> nn.Sequential:
    """MONAI's `Convolution`: the layer as a child named `conv`."""
    return nn.Sequential(OrderedDict(conv=module))


class _PatchRearrange(nn.Module):
    """(B, D, H, W, C) → (B, n_patches, p³·C), each patch's vector in the
    order (p1 p2 p3 c): the einops Rearrange of MONAI's perceptron patch
    embedding, channels-last."""

    def __init__(self, patch_size: int):
        super().__init__()
        self.patch_size = patch_size

    def forward(self, x):
        B, D, H, W, C = x.shape
        p = self.patch_size
        g = (D // p, H // p, W // p)
        t = x.reshape(B, g[0], p, g[1], p, g[2], p, C)
        return t.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(B, -1, p ** 3 * C)


class PatchEmbeddingBlock(nn.Module):
    def __init__(self, in_channels: int, img_size: Sequence[int],
                 patch_size: int, hidden: int):
        super().__init__()
        n_patches = 1
        for s in img_size:
            n_patches *= s // patch_size
        self.patch_embeddings = nn.Sequential(
            _PatchRearrange(patch_size),
            Linear(patch_size ** 3 * in_channels, hidden))
        self.position_embeddings = nn.Parameter(torch.zeros(1, n_patches, hidden))

    def reset_parameters(self, generator=None):
        _trunc_normal_(self.position_embeddings, 0.02, generator)

    def forward(self, x):
        return self.patch_embeddings(x) + self.position_embeddings


class SABlock(nn.Module):
    """Fused qkv Linear (no bias), per-head scaled dot product with the
    softmax in float32, output Linear."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(hidden, hidden * 3, bias=False)
        self.out_proj = Linear(hidden, hidden)

    def forward(self, x):
        B, N, C = x.shape
        hd = C // self.heads
        q, k, v = self.qkv(x).reshape(B, N, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        a = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
        a = torch.softmax(a.float(), dim=-1).to(x.dtype)
        o = torch.matmul(a, v).transpose(1, 2).reshape(B, N, C)
        return self.out_proj(o)


class MLPBlock(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int):
        super().__init__()
        self.linear1 = Linear(hidden, mlp_dim)
        self.linear2 = Linear(mlp_dim, hidden)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x), approximate="tanh"))


class ViTBlock(nn.Module):
    """MONAI TransformerBlock: pre-norm MHSA + pre-norm MLP."""

    jax_renames = ((r"mlp_fc(\d)", r"mlp.linear\1"),)

    def __init__(self, hidden: int, mlp_dim: int, heads: int):
        super().__init__()
        self.norm1 = LayerNorm(hidden)
        self.attn = SABlock(hidden, heads)
        self.norm2 = LayerNorm(hidden)
        self.mlp = MLPBlock(hidden, mlp_dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """Returns the normed last tokens and every block's output."""

    def __init__(self, in_channels, img_size, patch_size, hidden, mlp_dim,
                 depth, heads):
        super().__init__()
        self.patch_embedding = PatchEmbeddingBlock(in_channels, img_size,
                                                   patch_size, hidden)
        self.blocks = nn.ModuleList(ViTBlock(hidden, mlp_dim, heads)
                                    for _ in range(depth))
        self.norm = LayerNorm(hidden)

    def forward(self, x):
        t = self.patch_embedding(x)
        hidden_states = []
        for blk in self.blocks:
            t = blk(t)
            hidden_states.append(t)
        return self.norm(t), hidden_states


class UnetrBasicBlock(nn.Module):
    """UnetrBasicBlock, res_block=True: an UnetResBlock as `layer`."""

    def __init__(self, in_channels, out_channels, norm_name):
        super().__init__()
        self.layer = UnetResBlock(in_channels, out_channels, 3, 1, norm_name)

    def forward(self, x):
        return self.layer(x)


class UnetrPrUpBlock(nn.Module):
    """UnetrPrUpBlock, conv_block=False (upstream's default): deconv
    (in → out, k2 s2), then num_layer × deconv (out → out, k2 s2)."""

    jax_renames = ((r"blocks_(\d+)", r"blocks.\1"),)

    def __init__(self, in_channels: int, out_channels: int, num_layer: int):
        super().__init__()
        self.transp_conv_init = _wrapped(
            ConvTranspose(in_channels, out_channels, 2, 2, bias=False))
        self.blocks = nn.ModuleList(
            _wrapped(ConvTranspose(out_channels, out_channels, 2, 2, bias=False))
            for _ in range(num_layer))

    def forward(self, x):
        x = self.transp_conv_init(x)
        for blk in self.blocks:
            x = blk(x)
        return x


class UnetrUpBlock(nn.Module):
    """UnetrUpBlock, res_block=True: deconv (in → out, k2 s2), concat the
    skip, UnetResBlock(2·out → out, 3³)."""

    def __init__(self, in_channels: int, out_channels: int, norm_name: str):
        super().__init__()
        self.transp_conv = _wrapped(
            ConvTranspose(in_channels, out_channels, 2, 2, bias=False))
        self.conv_block = UnetResBlock(2 * out_channels, out_channels, 3, 1,
                                       norm_name)

    def forward(self, x, skip):
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=-1))


class UNETR(nn.Module):
    """UNETR (unetr.py:22-230): ViT-hidden with 16³ perceptron patch
    embedding; skips from the raw input (UnetrBasicBlock) and from the
    token maps after blocks 4/7/10 (hidden_states_out[3/6/9]) upsampled by
    deconv chains; UnetrUpBlock decoder; 1³ head."""

    jax_renames = (("patch_embed", "vit.patch_embedding.patch_embeddings.1"),
                   ("position_embeddings", "vit.patch_embedding.position_embeddings"),
                   (r"vit_block_(\d+)", r"vit.blocks.\1"),
                   ("vit_norm", "vit.norm"),
                   ("encoder1", "encoder1.layer"))

    def __init__(self, n_classes: int = 2, in_channels: int = 1,
                 img_size: Sequence[int] = (96, 96, 96), feature_size: int = 16,
                 hidden: int = 768, mlp_dim: int = 3072, heads: int = 12,
                 depth: int = 12, patch_size: int = 16,
                 norm_name: str = "instance"):
        super().__init__()
        self.patch_size, self.hidden = patch_size, hidden
        self.grid = tuple(s // patch_size for s in img_size)
        fs = feature_size
        self.vit = ViT(in_channels, img_size, patch_size, hidden, mlp_dim,
                       depth, heads)
        self.encoder1 = UnetrBasicBlock(in_channels, fs, norm_name)
        self.encoder2 = UnetrPrUpBlock(hidden, fs * 2, 2)
        self.encoder3 = UnetrPrUpBlock(hidden, fs * 4, 1)
        self.encoder4 = UnetrPrUpBlock(hidden, fs * 8, 0)
        self.decoder5 = UnetrUpBlock(hidden, fs * 8, norm_name)
        self.decoder4 = UnetrUpBlock(fs * 8, fs * 4, norm_name)
        self.decoder3 = UnetrUpBlock(fs * 4, fs * 2, norm_name)
        self.decoder2 = UnetrUpBlock(fs * 2, fs, norm_name)
        self.out = UnetOutBlock(fs, n_classes)

    def forward(self, x):
        B = x.shape[0]
        t, hidden_states = self.vit(x)

        def proj(tok):
            return tok.reshape(B, *self.grid, self.hidden)

        enc1 = self.encoder1(x)
        enc2 = self.encoder2(proj(hidden_states[3]))
        enc3 = self.encoder3(proj(hidden_states[6]))
        enc4 = self.encoder4(proj(hidden_states[9]))
        d3 = self.decoder5(proj(t), enc4)
        d2 = self.decoder4(d3, enc3)
        d1 = self.decoder3(d2, enc2)
        return self.out(self.decoder2(d1, enc1))

