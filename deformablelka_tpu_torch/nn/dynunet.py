"""UNet blocks of MONAI's dynunet (channels-last), 3D.

Port of `UnetResBlock` and `UnetOutBlock` in
`deformablelka_tpu/nn/dynunet.py`: conv → norm → leaky ReLU (0.01) twice,
with a 1³ projected residual when the channels or the stride change. Each
conv sits in a `Sequential` child named `conv`, as MONAI's `Convolution`
does, so the state_dict keys are upstream's (`conv1.conv.weight`).
Norm "instance" is affine-free (MONAI's default), "batch" is eval-mode
batch norm.
"""

from __future__ import annotations

from collections import OrderedDict

import torch.nn as nn
import torch.nn.functional as F

from deformablelka_tpu_torch.nn.layers import Conv3d
from deformablelka_tpu_torch.nn.norms import BatchNorm, InstanceNorm


def _conv(in_channels, out_channels, kernel_size, stride=1, bias=False):
    return nn.Sequential(OrderedDict(conv=Conv3d(
        in_channels, out_channels, kernel_size, stride=stride,
        padding="same", bias=bias)))


def _norm(norm_name: str, channels: int) -> nn.Module:
    if norm_name == "instance":
        return InstanceNorm(channels, affine=False)
    if norm_name == "batch":
        return BatchNorm(channels)
    raise ValueError(f"unsupported norm {norm_name}")


def lrelu(x):
    return F.leaky_relu(x, 0.01)


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


class UnetOutBlock(nn.Module):
    """1³ conv with bias to the class logits."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = _conv(in_channels, out_channels, 1, bias=True)

    def forward(self, x):
        return self.conv(x)
