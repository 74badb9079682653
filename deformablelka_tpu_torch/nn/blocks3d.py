"""The D-LKA gate of the 3D blocks, channels-last (B, D, H, W, C).

Port of `DeformConvPack3d`, `_dw_pair3d`, `LKA3dDeform` and
`GatedAttention3d` in `deformablelka_tpu/nn/blocks3d.py`:

    proj_1 → GELU → [dw5³ → dw7³-dil3 → DeformConvPack3d 3³ → 1³ → · u]
           → proj_2 → + shortcut

The dw pair runs as one call of `ops.kernels.dw_chain3d` and the deform
conv as one call of `ops.kernels.deform_conv3d`: the hand kernels on a
CUDA tensor, their plain versions on a CPU tensor. Modules hold their
weights in torch's layout and hand the kernels the JAX layout.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from deformablelka_tpu_torch.nn.layers import Conv3d, _uniform_, gelu
from deformablelka_tpu_torch.ops import kernels


def _jax_layout(w):
    """(Cout, Cin/g, kd, kh, kw) → contiguous (kd, kh, kw, Cin/g, Cout)."""
    return w.permute(2, 3, 4, 1, 0).contiguous()


class DeformConvPack3d(nn.Module):
    """3³ deformable conv (stride 1, pad 1) whose offsets a 3³ conv
    (`conv_offset`, 81 channels: (Δd, Δh, Δw) per tap) predicts.

    Init, as the JAX package: the deform weight U(±1/sqrt(27·C)), its bias
    0; the offset conv's weight 0 and its bias torch's default
    U(±1/sqrt(27·C)). So at init every voxel samples at the same
    non-integer offset per tap, and the offset gradient is not zero.
    """

    def __init__(self, dim: int):
        super().__init__()
        self.conv_offset = Conv3d(dim, 81, 3, padding=1)
        self.weight = nn.Parameter(torch.empty(dim, dim, 3, 3, 3))
        self.bias = nn.Parameter(torch.empty(dim))

    def reset_parameters(self, generator=None):
        # runs after conv_offset's own reset (init_parameters' order)
        with torch.no_grad():
            self.conv_offset.weight.zero_()
            self.bias.zero_()
        _uniform_(self.weight, 1.0 / math.sqrt(27 * self.weight.shape[1]),
                  generator)

    def forward(self, x):
        offsets = self.conv_offset(x).contiguous()
        return kernels.deform_conv3d(x.contiguous(), offsets,
                                     _jax_layout(self.weight), self.bias)


def _dw_pair3d(x, conv0: Conv3d, conv_spatial: Conv3d):
    """dw5³ → dw7³-dil3 with their biases, as one fused chain."""
    return kernels.dw_chain3d(x.contiguous(), _jax_layout(conv0.weight),
                              conv0.bias, _jax_layout(conv_spatial.weight),
                              conv_spatial.bias)


class LKA3dDeform(nn.Module):
    """The published 3D D-LKA gate: u · conv1(deform(dw7d3(dw5(u))))."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv0 = Conv3d(dim, dim, 5, padding=2, groups=dim)
        self.conv_spatial = Conv3d(dim, dim, 7, padding=9, dilation=3,
                                   groups=dim)
        self.deform_conv = DeformConvPack3d(dim)
        self.conv1 = Conv3d(dim, dim, 1)

    def forward(self, x):
        attn = _dw_pair3d(x, self.conv0, self.conv_spatial)
        attn = self.deform_conv(attn)
        return x * self.conv1(attn)


class GatedAttention3d(nn.Module):
    """proj_1 → GELU → gating unit → proj_2, plus the shortcut."""

    def __init__(self, dim: int, gate=LKA3dDeform):
        super().__init__()
        self.proj_1 = Conv3d(dim, dim, 1)
        self.spatial_gating_unit = gate(dim)
        self.proj_2 = Conv3d(dim, dim, 1)

    def forward(self, x):
        y = gelu(self.proj_1(x))
        y = self.spatial_gating_unit(y)
        return self.proj_2(y) + x
