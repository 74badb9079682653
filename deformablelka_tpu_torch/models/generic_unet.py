"""nnUNet's Generic U-Net, 2D and 3D, channels-last.

Port of `deformablelka_tpu/models/generic_unet.py`. Upstream's network,
as the JAX package re-derived it (3D/d_lka_former/network_architecture/
generic_UNet.py): Conv-InstanceNorm-LeakyReLU(0.01) × `conv_per_stage`
per stage, features doubling per pool up to `max_features`, strided-conv
downsampling, transposed-conv upsampling (kernel = stride, no bias),
concatenated skips, a 1×1 seg head (no bias) per decoder stage for deep
supervision. The plans give the pool and conv kernel sizes
(`generic_unet_3d_from_plans`). As in the JAX package, the cap is 320 in
2D too (upstream caps 2D at 512), and `residual=True` (the residual
planner variant) adds each stage's input, through a 1×1 projection where
the channels or the stride change, to its output.

Attribute names are upstream's (`conv_blocks_context.s.blocks.i.conv`,
`.instnorm`; the bottleneck and every decoder stage a pair `.0` of
`conv_per_stage - 1` convs and `.1` of one; `tu.j`, `seg_outputs.j`,
with decoder index j = num_pool - 1 - s), so `state_dict()` converts
with `deformablelka_tpu.convert.torch_loader.convert_generic_unet`; the
residual variant's projections are `proj`, a name of this package only.
Weights are drawn as the package's other layers draw them (U(±1/√fan_in)),
not with upstream's He init. No hand-written kernel runs here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from deformablelka_tpu_torch.models.dlka_former import _build
from deformablelka_tpu_torch.nn.layers import Conv2d, Conv3d, StrideConvTranspose
from deformablelka_tpu_torch.nn.norms import InstanceNorm


def lrelu(x):
    return F.leaky_relu(x, 0.01)


def _conv(ndim: int, in_channels: int, out_channels: int, kernel, stride=1,
          padding=0, bias: bool = True) -> nn.Module:
    return (Conv3d if ndim == 3 else Conv2d)(
        in_channels, out_channels, kernel, stride=stride, padding=padding, bias=bias)


class ConvNormLRelu(nn.Module):
    """Conv (torch's symmetric padding k//2) → affine instance norm →
    leaky ReLU 0.01."""

    jax_renames = (("norm", "instnorm"),)

    def __init__(self, in_channels: int, out_channels: int, kernel, stride):
        super().__init__()
        self.conv = _conv(len(kernel), in_channels, out_channels, tuple(kernel),
                          tuple(stride), tuple(k // 2 for k in kernel))
        self.instnorm = InstanceNorm(out_channels)

    def forward(self, x):
        return lrelu(self.instnorm(self.conv(x)))


def _proj(residual, in_channels, out_channels, kernel, stride):
    """The residual variant's 1×1 projection, where the stage changes the
    channels or the stride; else None."""
    if residual and (in_channels != out_channels or any(s != 1 for s in stride)):
        return _conv(len(kernel), in_channels, out_channels, (1,) * len(kernel),
                     tuple(stride), 0, bias=False)
    return None


class StackedConvLayers(nn.Module):
    """`n_convs` ConvNormLRelu, the first with `first_stride`."""

    jax_renames = ((r"block(\d+)", r"blocks.\1"),)

    def __init__(self, in_channels: int, out_channels: int, n_convs: int = 2,
                 kernel: Sequence[int] = (3, 3, 3),
                 first_stride: Optional[Sequence[int]] = None,
                 residual: bool = False):
        super().__init__()
        first_stride = tuple(first_stride or (1,) * len(kernel))
        ones = (1,) * len(kernel)
        self.blocks = nn.Sequential(*[
            ConvNormLRelu(in_channels if i == 0 else out_channels, out_channels,
                          kernel, first_stride if i == 0 else ones)
            for i in range(n_convs)])
        self.residual = residual
        self.proj = _proj(residual, in_channels, out_channels, kernel, first_stride)

    def forward(self, x):
        y = self.blocks(x)
        if self.residual:
            y = y + (x if self.proj is None else self.proj(x))
        return y


class StagePair(nn.Module):
    """The bottleneck's and each decoder stage's convs as upstream holds
    them: `0`, StackedConvLayers of `n_convs - 1` (the first strided), and
    `1`, StackedConvLayers of one; the residual variant adds the pair's
    input (`proj`) to its output."""

    def __init__(self, in_channels: int, out_channels: int, n_convs: int,
                 kernel: Sequence[int], first_stride: Optional[Sequence[int]] = None,
                 residual: bool = False):
        super().__init__()
        if n_convs < 2:
            raise ValueError("conv_per_stage must be at least 2")
        first_stride = tuple(first_stride or (1,) * len(kernel))
        self.add_module("0", StackedConvLayers(in_channels, out_channels, n_convs - 1,
                                               kernel, first_stride))
        self.add_module("1", StackedConvLayers(out_channels, out_channels, 1, kernel))
        self.residual = residual
        self.proj = _proj(residual, in_channels, out_channels, kernel, first_stride)
        self.jax_renames = tuple((f"block{i}", f"0.blocks.{i}")
                                 for i in range(n_convs - 1)) + (
            (f"block{n_convs - 1}", "1.blocks.0"),)

    def forward(self, x):
        y = self._modules["1"](self._modules["0"](x))
        if self.residual:
            y = y + (x if self.proj is None else self.proj(x))
        return y


class GenericUNet(nn.Module):
    """`num_pool` stages; `pool_kernel_sizes` (num_pool, ndim) strides from
    the plans; returns the deep-supervision list [full, 1/2, 1/4] when
    `do_ds`, else the full-resolution logits."""

    def __init__(self, num_classes: int, in_channels: int = 1,
                 base_num_features: int = 32, num_pool: int = 5,
                 pool_kernel_sizes: Optional[Sequence] = None,
                 conv_kernel_sizes: Optional[Sequence] = None,
                 max_features: int = 320, do_ds: bool = True, ndim: int = 3,
                 conv_per_stage: int = 2, residual: bool = False):
        super().__init__()
        self.do_ds = do_ds
        pools = [tuple(p) for p in (pool_kernel_sizes or [(2,) * ndim] * num_pool)]
        kernels = [tuple(k) for k in (conv_kernel_sizes or [(3,) * ndim] * (num_pool + 1))]
        feats = [min(base_num_features * 2 ** i, max_features)
                 for i in range(num_pool + 1)]
        self.num_pool = num_pool
        self.conv_blocks_context = nn.ModuleList()
        cin = in_channels
        for s in range(num_pool):
            self.conv_blocks_context.append(StackedConvLayers(
                cin, feats[s], conv_per_stage, kernels[s],
                (1,) * ndim if s == 0 else pools[s - 1], residual))
            cin = feats[s]
        self.conv_blocks_context.append(StagePair(
            cin, feats[num_pool], conv_per_stage, kernels[num_pool],
            pools[num_pool - 1], residual))
        # decoder, deepest first: index j is stage s = num_pool - 1 - j
        self.tu = nn.ModuleList()
        self.conv_blocks_localization = nn.ModuleList()
        self.seg_outputs = nn.ModuleList()
        for s in reversed(range(num_pool)):
            self.tu.append(StrideConvTranspose(feats[s + 1], feats[s], pools[s],
                                               ndim, bias=False))
            self.conv_blocks_localization.append(StagePair(
                2 * feats[s], feats[s], conv_per_stage, kernels[s], None, residual))
            self.seg_outputs.append(_conv(ndim, feats[s], num_classes,
                                          (1,) * ndim, bias=False))
        last = num_pool - 1
        self.jax_renames = tuple(
            [(f"down{s}", f"conv_blocks_context.{s}") for s in range(num_pool)]
            + [("bottleneck", f"conv_blocks_context.{num_pool}")]
            + [(f"{jax}{s}", f"{torch_}.{last - s}") for s in range(num_pool)
               for jax, torch_ in (("dec", "conv_blocks_localization"),
                                   ("up", "tu"), ("seg", "seg_outputs"))])

    def forward(self, x):
        skips = []
        h = x
        for stage in self.conv_blocks_context[:-1]:
            h = stage(h)
            skips.append(h)
        h = self.conv_blocks_context[-1](h)
        seg_outputs = []
        for j in range(self.num_pool):
            h = self.tu[j](h)
            h = torch.cat([h, skips[self.num_pool - 1 - j]], dim=-1)
            h = self.conv_blocks_localization[j](h)
            seg_outputs.append(self.seg_outputs[j](h))
        seg_outputs = seg_outputs[::-1]  # [full-res, /2, /4, ...]
        if self.do_ds:
            return seg_outputs[:3]
        return seg_outputs[0]


def generic_unet_3d_from_plans(plans_stage: dict, num_classes: int,
                               do_ds: bool = True, plans: dict | None = None,
                               *, seed: int = 0, device="cuda") -> GenericUNet:
    """Built from a plans stage dict (`pool_op_kernel_sizes` /
    `conv_kernel_sizes`, default_configuration.py's pathway), with random
    weights from `seed`, in eval mode, on `device`. Pass the top-level
    `plans` for the planner variants' knobs (`conv_per_stage`,
    `residual`)."""
    pools = plans_stage.get("pool_op_kernel_sizes")
    kernels = plans_stage.get("conv_kernel_sizes")
    plans = plans or {}
    return _build(GenericUNet(num_classes=num_classes,
                              num_pool=len(pools) if pools else 5,
                              pool_kernel_sizes=pools, conv_kernel_sizes=kernels,
                              do_ds=do_ds,
                              conv_per_stage=int(plans.get("conv_per_stage", 2)),
                              residual=bool(plans.get("residual", False))),
                  seed, device)
