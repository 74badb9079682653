"""Channels-last convolution helpers on `F.conv2d` / `F.conv3d` /
`F.conv_transpose3d`.

Port of `deformablelka_tpu/ops/convs.py`. Activations are channels-last,
(B, D, H, W, C) or (B, H, W, C), as in the JAX package; weights are in
torch's layout, (Cout, Cin // groups, [kd,] kh, kw) for a conv and (Cin,
Cout, kd, kh, kw) for a transposed conv, because the modules hold them
so. A channels-last tensor seen through `permute(0, 4, 1, 2, 3)` is a
`channels_last_3d` NCDHW tensor (and through `permute(0, 3, 1, 2)` a
`channels_last` NCHW one), so no copy is made on the way in or out.

The TPU rewrites of the JAX module (s2d, im2col, z-decomposed and
à-trous depthwise, depth-to-space transposed conv) compute the same
functions and have no counterpart here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _tuple(v, n: int) -> tuple:
    if isinstance(v, (tuple, list)):
        if len(v) != n:
            raise ValueError(f"expected {n} values, got {v}")
        return tuple(v)
    return (v,) * n


def same_padding(kernel_size, stride, dilation=1, ndim: int | None = None):
    """Torch-style symmetric padding `(k_eff - s + 1) // 2` per spatial dim
    (MONAI `get_padding`). Returns a list of (lo, hi) pairs."""
    if ndim is None:
        ndim = len(kernel_size) if isinstance(kernel_size, (tuple, list)) else 1
    pads = []
    for k, s, d in zip(_tuple(kernel_size, ndim), _tuple(stride, ndim),
                       _tuple(dilation, ndim)):
        p = (d * (k - 1) + 1 - s + 1) // 2
        if p < 0:
            raise ValueError("negative padding; adjust kernel/stride")
        pads.append((p, p))
    return pads


def to_ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def to_ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


def conv3d(x, w, bias=None, *, stride=1, padding="same", dilation=1,
           groups: int = 1):
    """3D conv. x: (B, D, H, W, Cin); w: (Cout, Cin // groups, kd, kh, kw).
    `padding` is "same", an int or three ints (symmetric)."""
    st = _tuple(stride, 3)
    dil = _tuple(dilation, 3)
    if padding == "same":
        pad = tuple(lo for lo, _ in same_padding(tuple(w.shape[2:]), st, dil, 3))
    else:
        pad = _tuple(padding, 3)
    y = F.conv3d(to_ncdhw(x), w, bias, st, pad, dil, groups)
    return to_ndhwc(y)


def depthwise_conv3d(x, w, bias=None, *, stride=1, padding="same",
                     dilation=1):
    """Depthwise 3D conv; w: (C, 1, kd, kh, kw)."""
    return conv3d(x, w, bias, stride=stride, padding=padding,
                  dilation=dilation, groups=x.shape[-1])


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d(x, w, bias=None, *, stride=1, padding="same", dilation=1,
           groups: int = 1):
    """2D conv. x: (B, H, W, Cin); w: (Cout, Cin // groups, kh, kw).
    `padding` is "same", an int or two ints (symmetric)."""
    st = _tuple(stride, 2)
    dil = _tuple(dilation, 2)
    if padding == "same":
        pad = tuple(lo for lo, _ in same_padding(tuple(w.shape[2:]), st, dil, 2))
    else:
        pad = _tuple(padding, 2)
    return to_nhwc(F.conv2d(to_nchw(x), w, bias, st, pad, dil, groups))


def depthwise_conv2d(x, w, bias=None, *, stride=1, padding="same",
                     dilation=1):
    """Depthwise 2D conv; w: (C, 1, kh, kw)."""
    return conv2d(x, w, bias, stride=stride, padding=padding,
                  dilation=dilation, groups=x.shape[-1])


def conv_transpose(x, w, bias=None, *, stride):
    """Transposed 3D conv as torch's ConvTranspose3d with padding
    (k - s + 1) // 2 and output_padding 2p + s - k (MONAI
    `get_conv_layer`), so the output size is input × stride.
    x: (B, D, H, W, Cin); w: (Cin, Cout, kd, kh, kw)."""
    ks = tuple(w.shape[2:])
    st = _tuple(stride, 3)
    pad = [lo for lo, _ in same_padding(ks, st, 1, 3)]
    out_pad = [2 * p + s - k for p, s, k in zip(pad, st, ks)]
    if any(op < 0 for op in out_pad):
        raise ValueError("negative output padding")
    y = F.conv_transpose3d(to_ncdhw(x), w, bias, st, pad, out_pad)
    return to_ndhwc(y)


__all__ = ["same_padding", "conv2d", "depthwise_conv2d", "conv3d",
           "depthwise_conv3d", "conv_transpose", "to_nchw", "to_nhwc",
           "to_ncdhw", "to_ndhwc"]
