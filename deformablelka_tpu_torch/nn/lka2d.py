"""The 2D LKA and deformable-LKA blocks, channels-last (B, H, W, C).

Port of `deformablelka_tpu/nn/lka2d.py` (upstream's
`deformable_LKA.py`, `LKA.py` and `MaxViT_deform_LKA.py:20-189`), with
upstream's torch attribute names and layouts:

    deformableLKABlock: x + ls1 · deformable_LKA_Attention(norm1(x)),
                        then + ls2 · Mlp(norm2(·))
    deformable_LKA_Attention: proj_1 → GELU → [DeformConv 5² → DeformConv
                        7²-dil3 → conv1 → · u] → proj_2 → + shortcut
    LKABlock: the same with SpatialAttention, whose gate is the plain
                        chain dw5² → dw7²-dil3 → conv1 → · u

Each `DeformConv` is one call of `ops.kernels.deform_dw_conv2d` and each
LKA chain one call of `ops.kernels.dw_chain2d`: the hand kernels on a
CUDA tensor, their plain versions on a CPU tensor. The deformable gate
(the two deform convs, the 1×1 and the product) opens the span
`dlka.lka2d` (args: size, channels; `profiling.span`). Modules hold their
weights in torch's layout and hand the kernels the JAX layout.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from deformablelka_tpu_torch import profiling
from deformablelka_tpu_torch.nn.layers import Conv2d, DropPath, _uniform_, gelu
from deformablelka_tpu_torch.nn.norms import LayerNorm
from deformablelka_tpu_torch.ops import kernels


def _jax_layout(w):
    """(Cout, Cin/g, kh, kw) → contiguous (kh, kw, Cin/g, Cout)."""
    return w.permute(2, 3, 1, 0).contiguous()


class DeformDwWeight(nn.Module):
    """The weight of torchvision's depthwise `DeformConv2d` (bias-free):
    (C, 1, k, k). Init as the JAX package: U(±1/k)."""

    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, 1, kernel_size,
                                               kernel_size))

    def reset_parameters(self, generator=None):
        _uniform_(self.weight, 1.0 / self.weight.shape[-1], generator)


class DeformConv(nn.Module):
    """`offset_net`, a dense conv with the deform conv's kernel, padding
    and dilation, predicts (Δy, Δx) per tap; the depthwise deformable conv
    (`deform_conv`, stride 1, padding (k // 2)·dil) samples with them."""

    def __init__(self, channels: int, kernel_size: int, padding: int,
                 dilation: int = 1):
        super().__init__()
        if padding != (kernel_size // 2) * dilation:
            raise ValueError("only 'same' padding is ported")
        self.dilation = dilation
        self.offset_net = Conv2d(channels, 2 * kernel_size ** 2, kernel_size,
                                 padding=padding, dilation=dilation)
        self.deform_conv = DeformDwWeight(channels, kernel_size)

    def forward(self, x):
        offsets = self.offset_net(x)
        return kernels.deform_dw_conv2d(x.contiguous(), offsets.contiguous(),
                                        _jax_layout(self.deform_conv.weight),
                                        self.dilation)


class deformable_LKA(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv0 = DeformConv(dim, 5, padding=2)
        self.conv_spatial = DeformConv(dim, 7, padding=9, dilation=3)
        self.conv1 = Conv2d(dim, dim, 1)

    def forward(self, x):
        with profiling.span("dlka.lka2d", size=tuple(x.shape[1:3]), channels=x.shape[-1]):
            return x * self.conv1(self.conv_spatial(self.conv0(x)))


class AttentionModule(nn.Module):
    """The plain LKA gate: x · conv1(dw7²-dil3(dw5²(x)))."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv0 = Conv2d(dim, dim, 5, padding=2, groups=dim)
        self.conv_spatial = Conv2d(dim, dim, 7, padding=9, dilation=3,
                                   groups=dim)
        self.conv1 = Conv2d(dim, dim, 1)

    def forward(self, x):
        attn = kernels.dw_chain2d(
            x.contiguous(), _jax_layout(self.conv0.weight), self.conv0.bias,
            _jax_layout(self.conv_spatial.weight), self.conv_spatial.bias)
        return x * self.conv1(attn)


class _GatedAttention(nn.Module):
    """proj_1 → GELU → spatial_gating_unit → proj_2 → + shortcut."""

    def __init__(self, dim: int, gate: nn.Module):
        super().__init__()
        self.proj_1 = Conv2d(dim, dim, 1)
        self.spatial_gating_unit = gate
        self.proj_2 = Conv2d(dim, dim, 1)

    def forward(self, x):
        y = self.spatial_gating_unit(gelu(self.proj_1(x)))
        return self.proj_2(y) + x


class deformable_LKA_Attention(_GatedAttention):
    def __init__(self, dim: int):
        super().__init__(dim, deformable_LKA(dim))


class SpatialAttention(_GatedAttention):
    def __init__(self, dim: int):
        super().__init__(dim, AttentionModule(dim))


class DWConvLKA(nn.Module):
    """3×3 depthwise conv."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x):
        return self.dwconv(x)


class Mlp(nn.Module):
    """1×1 conv → dw 3×3 → GELU → 1×1 conv (dropout 0)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Conv2d(dim, hidden, 1)
        self.dwconv = DWConvLKA(hidden)
        self.fc2 = Conv2d(hidden, dim, 1)

    def forward(self, x):
        return self.fc2(gelu(self.dwconv(self.fc1(x))))


class _LKABlockBase(nn.Module):
    """Pre-norm attention and MLP, each scaled per channel (layer scale,
    1e-2 at init) and added to the stream."""

    attention = None

    def __init__(self, dim: int, mlp_ratio: float = 4.0,
                 drop_path: float = 0.0):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = self.attention(dim)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.layer_scale_1 = nn.Parameter(torch.empty(dim))
        self.layer_scale_2 = nn.Parameter(torch.empty(dim))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.layer_scale_1.fill_(1e-2)
            self.layer_scale_2.fill_(1e-2)

    def forward(self, x):
        x = x + self.drop_path(self.layer_scale_1 * self.attn(self.norm1(x)))
        return x + self.drop_path(self.layer_scale_2 * self.mlp(self.norm2(x)))


class deformableLKABlock(_LKABlockBase):
    attention = deformable_LKA_Attention


class LKABlock(_LKABlockBase):
    attention = SpatialAttention
