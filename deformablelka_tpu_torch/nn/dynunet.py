"""UNet blocks of MONAI's dynunet (channels-last).

Port of `deformablelka_tpu/nn/dynunet.py`: `UnetResBlock` (3D), conv →
norm → leaky ReLU (0.01) twice, with a 1³ projected residual when the
channels or the stride change; `UnetBasicBlock`, the same without the
residual; `UnetUpBlock`, a transposed conv (kernel = stride, no bias),
the skip concatenated after it, then an `UnetBasicBlock`; `UnetOutBlock`
(3D), a 1³ conv with bias; and UNETR's blocks with `res_block=True`
(UNETR, Swin UNETR): `UnetrBasicBlock`, an `UnetResBlock` as `layer`,
and `UnetrUpBlock`, a 2³ stride-2 transposed conv, the skip concatenated,
an `UnetResBlock`. `UnetBasicBlock` and `UnetUpBlock` take
`spatial_dims` 2 or 3. Each conv sits in a `Sequential` child named
`conv`, as MONAI's `Convolution` does, so the state_dict keys are
upstream's (`conv1.conv.weight`, `transp_conv.conv.weight`,
`conv_block.conv1.conv.weight`). Norm "instance" is affine-free (MONAI's
default), "batch" is eval-mode batch norm. Every block runs in its
input's type, as the JAX blocks do; a bfloat16 skip meeting a float32
input promotes at the concatenation.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F

from deformablelka_tpu_torch.nn.layers import Conv2d, Conv3d, ConvTranspose, scalar_in
from deformablelka_tpu_torch.nn.norms import BatchNorm, InstanceNorm


def _conv(in_channels, out_channels, kernel_size, stride=1, bias=False,
          spatial_dims: int = 3):
    conv = Conv3d if spatial_dims == 3 else Conv2d
    return nn.Sequential(OrderedDict(conv=conv(
        in_channels, out_channels, kernel_size, stride=stride,
        padding="same", bias=bias)))


def _norm(norm_name: str, channels: int) -> nn.Module:
    if norm_name == "instance":
        return InstanceNorm(channels, affine=False)
    if norm_name == "batch":
        return BatchNorm(channels)
    raise ValueError(f"unsupported norm {norm_name}")


def lrelu(x):
    """flax's leaky ReLU (0.01), its slope in x's type."""
    return F.leaky_relu(x, scalar_in(0.01, x.dtype))


class UnetResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size=3,
                 stride=1, norm_name: str = "instance"):
        super().__init__()
        self.conv1 = _conv(in_channels, out_channels, kernel_size, stride)
        self.conv2 = _conv(out_channels, out_channels, kernel_size, 1)
        self.norm1 = _norm(norm_name, out_channels)
        self.norm2 = _norm(norm_name, out_channels)
        strides = stride if isinstance(stride, (tuple, list)) else [stride]
        self.downsample = (in_channels != out_channels
                           or any(s != 1 for s in strides))
        if self.downsample:
            self.conv3 = _conv(in_channels, out_channels, 1, stride)
            self.norm3 = _norm(norm_name, out_channels)

    def forward(self, x):
        out = lrelu(self.norm1(self.conv1(x)))
        out = self.norm2(self.conv2(out))
        residual = x
        if self.downsample:
            residual = self.norm3(self.conv3(x))
        return lrelu(out + residual)


class UnetBasicBlock(nn.Module):
    """conv (stride) → norm → leaky ReLU → conv → norm → leaky ReLU."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int,
                 kernel_size=3, stride=1, norm_name: str = "instance"):
        super().__init__()
        self.conv1 = _conv(in_channels, out_channels, kernel_size, stride,
                           spatial_dims=spatial_dims)
        self.conv2 = _conv(out_channels, out_channels, kernel_size, 1,
                           spatial_dims=spatial_dims)
        self.norm1 = _norm(norm_name, out_channels)
        self.norm2 = _norm(norm_name, out_channels)

    def forward(self, x):
        out = lrelu(self.norm1(self.conv1(x)))
        return lrelu(self.norm2(self.conv2(out)))


class UnetUpBlock(nn.Module):
    """Transposed conv (kernel = stride = `upsample_kernel_size`, no
    bias), concatenated with the skip, then an `UnetBasicBlock`
    (2·out → out, `kernel_size`)."""

    def __init__(self, spatial_dims: int, in_channels: int, out_channels: int,
                 kernel_size, upsample_kernel_size,
                 norm_name: str = "instance"):
        super().__init__()
        self.transp_conv = nn.Sequential(OrderedDict(conv=ConvTranspose(
            in_channels, out_channels, upsample_kernel_size,
            stride=upsample_kernel_size, bias=False, ndim=spatial_dims)))
        self.conv_block = UnetBasicBlock(spatial_dims, 2 * out_channels,
                                         out_channels, kernel_size, 1,
                                         norm_name)

    def forward(self, x, skip):
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=-1))


class UnetOutBlock(nn.Module):
    """1³ conv with bias to the class logits."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = _conv(in_channels, out_channels, 1, bias=True)

    def forward(self, x):
        return self.conv(x)


class UnetrBasicBlock(nn.Module):
    """UnetrBasicBlock, res_block=True: an UnetResBlock (3³) as `layer`."""

    def __init__(self, in_channels: int, out_channels: int, norm_name: str = "instance"):
        super().__init__()
        self.layer = UnetResBlock(in_channels, out_channels, 3, 1, norm_name)

    def forward(self, x):
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    """UnetrUpBlock, res_block=True: deconv (in → out, k2 s2, no bias),
    concat the skip, UnetResBlock(2·out → out, 3³)."""

    def __init__(self, in_channels: int, out_channels: int, norm_name: str = "instance"):
        super().__init__()
        self.transp_conv = nn.Sequential(OrderedDict(conv=ConvTranspose(
            in_channels, out_channels, 2, stride=2, bias=False)))
        self.conv_block = UnetResBlock(2 * out_channels, out_channels, 3, 1, norm_name)

    def forward(self, x, skip):
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=-1))
