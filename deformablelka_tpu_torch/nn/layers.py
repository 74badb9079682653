"""Primitive parameterised layers, channels-last, with torch weight layouts.

Port of `deformablelka_tpu/nn/layers.py`. Parameters are named `weight`
and `bias` and laid out as torch's own layers lay them out:

  Conv2d.weight        : (Cout, Cin // groups, kh, kw)
  Conv3d.weight        : (Cout, Cin // groups, kd, kh, kw)
  ConvTranspose.weight : (Cin, Cout, [kd,] kh, kw)
  PromotingStrideConvTranspose.weight : (Cin, Cout, *stride), 2D or 3D
  Linear.weight        : (Cout, Cin)

Types: `Conv2d`, `Conv3d`, `ConvTranspose` and `Linear` are the JAX
package's own layers and run in their input's type (the weights cast to
it, `ops/convs.py`); the `Promoting*` layers stand for flax's
`nn.Conv` / `nn.ConvTranspose`, which promote a bfloat16 input to their
float32 weights (`ops.convs.promoted`).

Initialisation draws from the same distributions as the JAX package
(torch's defaults: U(±1/sqrt(fan_in)) for weight and bias) from an
explicit `torch.Generator`; see `init_parameters`.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from deformablelka_tpu_torch.ops import convs as C


def _uniform_(t: torch.Tensor, bound: float, generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """(Re)initialise every submodule that defines
    `reset_parameters(generator)`, children before their parent (so a
    parent may override what a child drew)."""
    for m in reversed(list(module.modules())):
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)


class Conv2d(nn.Module):
    """2D conv on (B, H, W, Cin); `padding` is "same" (MONAI rule), an
    int or two ints."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding="same", dilation=1, groups: int = 1,
                 bias: bool = True):
        super().__init__()
        ks = C._tuple(kernel_size, 2)
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, *ks))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters(self, generator=None):
        bound = 1.0 / math.sqrt(math.prod(self.weight.shape[1:]))
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def forward(self, x):
        return C.conv2d(x, self.weight, self.bias, stride=self.stride,
                        padding=self.padding, dilation=self.dilation,
                        groups=self.groups)


class Conv3d(nn.Module):
    """3D conv on (B, D, H, W, Cin); `padding` is "same" (MONAI rule),
    an int or three ints."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding="same", dilation=1, groups: int = 1,
                 bias: bool = True):
        super().__init__()
        ks = C._tuple(kernel_size, 3)
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, *ks))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters(self, generator=None):
        bound = 1.0 / math.sqrt(math.prod(self.weight.shape[1:]))
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def forward(self, x):
        return C.conv3d(x, self.weight, self.bias, stride=self.stride,
                        padding=self.padding, dilation=self.dilation,
                        groups=self.groups)


class PromotingConv2d(Conv2d):
    """`Conv2d` standing for flax's `nn.Conv`: the input promoted to the
    weights' type first."""

    def forward(self, x):
        return super().forward(C.promoted(x, self.weight, self.bias))


class PromotingConv3d(Conv3d):
    """`Conv3d` standing for flax's `nn.Conv`: the input promoted to the
    weights' type first."""

    def forward(self, x):
        return super().forward(C.promoted(x, self.weight, self.bias))


class ConvTranspose(nn.Module):
    """Transposed 3D (or, with `ndim=2`, 2D) conv with MONAI's padding
    rules (output = input × stride)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride, bias: bool = True, ndim: int = 3):
        super().__init__()
        ks = C._tuple(kernel_size, ndim)
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, *ks))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters(self, generator=None):
        # the JAX package takes fan_in = Cin · prod(k) for both
        bound = 1.0 / math.sqrt(math.prod(self.weight.shape[2:])
                                * self.weight.shape[0])
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def forward(self, x):
        return C.conv_transpose(x, self.weight, self.bias, stride=self.stride)


class PromotingStrideConvTranspose(nn.Module):
    """Transposed 2D or 3D conv whose kernel is its stride (no overlap, no
    padding), as torch's `ConvTranspose{2,3}d(Cin, Cout, s, stride=s)`:
    (B, *S, Cin) → (B, *S·s, Cout). Its JAX counterpart is flax's
    `nn.ConvTranspose`: it promotes its input to the weights' type, and it
    correlates where torch convolves, so the JAX kernel is this weight
    flipped in space (`jax_kernel_flipped`, read by
    `convert/jax_params.py`)."""

    jax_kernel_flipped = True

    def __init__(self, in_channels: int, out_channels: int, stride,
                 ndim: int = 3, bias: bool = True):
        super().__init__()
        self.stride = C._tuple(stride, ndim)
        self.weight = nn.Parameter(
            torch.empty(in_channels, out_channels, *self.stride))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters(self, generator=None):
        bound = 1.0 / math.sqrt(math.prod(self.weight.shape[2:])
                                * self.weight.shape[0])
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def forward(self, x):
        x = C.promoted(x, self.weight, self.bias)
        if len(self.stride) == 3:
            return C.to_ndhwc(F.conv_transpose3d(
                C.to_ncdhw(x), self.weight, self.bias, self.stride))
        return C.to_nhwc(F.conv_transpose2d(
            C.to_nchw(x), self.weight, self.bias, self.stride))


class Linear(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def reset_parameters(self, generator=None):
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def forward(self, x):
        w, bias, after = C.in_input_type(x, self.weight, self.bias)
        return C.add_bias(F.linear(x, w, bias), after)


class DropPath(nn.Module):
    """Stochastic depth. The port runs the models in eval (the JAX
    package's `deterministic=True`), where it is the identity."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        if self.rate and self.training:
            raise NotImplementedError("DropPath in training mode is not ported")
        return x


@functools.lru_cache(maxsize=None)
def scalar_in(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`: JAX casts a Python scalar (a weak type)
    to the array's type before it multiplies, so `0.01 * x` of a bfloat16
    `x` multiplies by bfloat16(0.01); torch would multiply by the float32
    value. Exact in float32."""
    return torch.tensor(value, dtype=dtype).item()


def gelu(x):
    """Exact (erf) GELU, as torch's nn.GELU()."""
    return F.gelu(x)
