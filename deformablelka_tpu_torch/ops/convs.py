"""Channels-last convolution helpers on `F.conv2d` / `F.conv3d` /
`F.conv_transpose3d`.

Port of `deformablelka_tpu/ops/convs.py`. Activations are channels-last,
(B, D, H, W, C) or (B, H, W, C), as in the JAX package; weights are in
torch's layout, (Cout, Cin // groups, [kd,] kh, kw) for a conv and (Cin,
Cout, kd, kh, kw) for a transposed conv, because the modules hold them
so. A channels-last tensor seen through `permute(0, 4, 1, 2, 3)` is a
`channels_last_3d` NCDHW tensor (and through `permute(0, 3, 1, 2)` a
`channels_last` NCHW one), so no copy is made on the way in or out.

Types follow the JAX module's rule: each conv casts its weight and bias
to the input's type (`w.astype(x.dtype)`), so a bfloat16 input runs the
conv in bfloat16 and returns bfloat16. In float32 the bias goes into the
conv call; in a narrower type it is added after the conv, rounded, as the
JAX module adds it (`out + bias.astype(out.dtype)`). The layers that
stand for flax's own `nn.Conv` / `nn.ConvTranspose` follow flax's rule
instead, `promoted`: a bfloat16 input meets float32 weights in float32.

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


_NARROW = (torch.bfloat16, torch.float16)


def in_input_type(x, w, bias):
    """(w, the bias to pass to the conv call, the bias to add after it),
    as the JAX package's convs and `Linear` take them: w in x's type; the
    bias in the call for float32, else after the call in x's type."""
    w = w.to(x.dtype)
    if bias is None or x.dtype not in _NARROW:
        return w, bias, None
    return w, None, bias.to(x.dtype)


def add_bias(y, bias):
    return y if bias is None else y + bias


def promoted(x, *params):
    """x in the type it promotes to with `params` (None skipped): flax's
    rule for its own layers (`promote_dtype`), under which a bfloat16
    input meets float32 weights in float32. The layers that stand for
    flax's `nn.Conv` or `nn.ConvTranspose` apply it."""
    dtype = x.dtype
    for p in params:
        if p is not None:
            dtype = torch.promote_types(dtype, p.dtype)
    return x.to(dtype)


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
    w, bias, after = in_input_type(x, w, bias)
    if _hand_wgrad(x, w, st, pad, dil, groups):
        y = _Conv3dHandWgrad.apply(x, w, bias, pad)
    else:
        y = F.conv3d(to_ncdhw(x), w, bias, st, pad, dil, groups)
    return add_bias(to_ndhwc(y), after)


_ONES3 = (1, 1, 1)


def hand_wgrad_shape(ci: int, co: int, k: int, voxels: int) -> bool:
    """Whether the hand kernel computes the weight gradient of a dense
    stride-1 k³ conv of `ci` → `co` channels over `voxels` voxels (B·D·H·W)
    faster than cuDNN's f32 channels-last one, by the device times of
    `chip_smoke.py` phase 26 at every such shape of the two training cells
    (PERF.md §6). 3³: up to 64 × 81 channel pairs, where cuDNN is 1.8-148×
    slower; from 96 × 96 and 128 × 81 pairs up cuDNN is 1.03-6.3× faster.
    1³: from 1024 voxels (cuDNN 1.2-400× slower); at 128 and 432 voxels,
    with 256-768 channels, cuDNN is 2-3× faster."""
    if k == 1:
        return voxels >= 1024
    return k == 3 and ci * co <= 64 * 81


def dense_unit_stride(x, w, st, pad, dil, groups) -> bool:
    """A float32 conv the hand weight gradient takes: x (B, D, H, W, Ci),
    a dense (groups 1) cubic 1³ or 3³ kernel at stride 1, dilation 1 and
    "same" padding."""
    k = w.shape[2]
    return (groups == 1 and x.dtype is torch.float32 and w.dtype is torch.float32
            and x.ndim == 5 and k in (1, 3) and w.shape[3] == k and w.shape[4] == k
            and st == _ONES3 and dil == _ONES3 and pad == (k // 2,) * 3)


def _hand_wgrad(x, w, st, pad, dil, groups) -> bool:
    """`conv3d`'s weight gradient goes to the hand kernel
    (`kernels.conv3d_wgrad`) where autograd will ask for it, on the card,
    for a conv of `dense_unit_stride`'s kind in `hand_wgrad_shape`'s
    region. Everything else (inference, depthwise, strided, other types)
    keeps autograd of `F.conv3d`."""
    return (torch.is_grad_enabled() and w.requires_grad and x.is_cuda
            and dense_unit_stride(x, w, st, pad, dil, groups)
            and hand_wgrad_shape(w.shape[1], w.shape[0], w.shape[2], x.numel() // x.shape[-1]))


class _Conv3dHandWgrad(torch.autograd.Function):
    """`F.conv3d` at stride 1, dilation 1, groups 1 on the channels-last
    view, the same call as `conv3d` makes; its backward asks cuDNN for the
    data and bias gradients alone (`convolution_backward`, as autograd of
    `F.conv3d` does) and the hand kernel for the weight gradient."""

    @staticmethod
    def forward(ctx, x, w, bias, pad):
        ctx.save_for_backward(x, w)
        ctx.pad = pad
        ctx.bias_sizes = None if bias is None else [bias.shape[0]]
        return F.conv3d(to_ncdhw(x), w, bias, _ONES3, pad, _ONES3, 1)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy):
        # imported here: `ops.kernels` imports this module
        from deformablelka_tpu_torch.ops import kernels

        x, w = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = db = dw = None
        if need_x or need_b:
            dx, _, db = torch.ops.aten.convolution_backward(
                gy, to_ncdhw(x), w, ctx.bias_sizes, _ONES3, ctx.pad, _ONES3, False,
                (0, 0, 0), 1, (need_x, False, need_b))
            dx = None if dx is None else to_ndhwc(dx)
        if need_w:
            dw = kernels.conv3d_wgrad(x.contiguous(), to_ndhwc(gy).contiguous(), w.shape[2])
        return dx, dw, db, None


def conv3d_weight_grad(x, g, k: int):
    """The weight gradient (Co, Ci, k, k, k) of `conv3d(x, w)` for a cubic
    k³ kernel (k odd), stride 1, dilation 1, groups 1, "same" padding, at
    the cotangent g (B, D, H, W, Co) of its output; x (B, D, H, W, Ci): for
    each tap, gᵀ times the slice of the zero-padded x it reads. The plain
    version of `kernels.conv3d_wgrad`."""
    r = k // 2
    B, D, H, W, ci = x.shape
    xp = F.pad(x, (0, 0, r, r, r, r, r, r))
    gt = g.reshape(-1, g.shape[-1]).t()
    taps = [gt @ xp[:, a:a + D, b:b + H, c:c + W].reshape(-1, ci)
            for a in range(k) for b in range(k) for c in range(k)]
    return torch.stack(taps, -1).reshape(g.shape[-1], ci, k, k, k)


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
    w, bias, after = in_input_type(x, w, bias)
    return add_bias(to_nhwc(F.conv2d(to_nchw(x), w, bias, st, pad, dil, groups)),
                    after)


def depthwise_conv2d(x, w, bias=None, *, stride=1, padding="same",
                     dilation=1):
    """Depthwise 2D conv; w: (C, 1, kh, kw)."""
    return conv2d(x, w, bias, stride=stride, padding=padding,
                  dilation=dilation, groups=x.shape[-1])


def conv_transpose(x, w, bias=None, *, stride):
    """Transposed 2D or 3D conv (by the input's rank) as torch's
    ConvTranspose{2,3}d with padding (k - s + 1) // 2 and output_padding
    2p + s - k (MONAI `get_conv_layer`), so the output size is input ×
    stride. x: (B, *S, Cin); w: (Cin, Cout, *k)."""
    nd = x.ndim - 2
    ks = tuple(w.shape[2:])
    st = _tuple(stride, nd)
    pad = [lo for lo, _ in same_padding(ks, st, 1, nd)]
    out_pad = [2 * p + s - k for p, s, k in zip(pad, st, ks)]
    if any(op < 0 for op in out_pad):
        raise ValueError("negative output padding")
    w, bias, after = in_input_type(x, w, bias)
    if nd == 3:
        y = to_ndhwc(F.conv_transpose3d(to_ncdhw(x), w, bias, st, pad, out_pad))
    else:
        y = to_nhwc(F.conv_transpose2d(to_nchw(x), w, bias, st, pad, out_pad))
    return add_bias(y, after)


__all__ = ["same_padding", "in_input_type", "add_bias", "promoted", "conv2d",
           "depthwise_conv2d", "conv3d", "conv3d_weight_grad", "hand_wgrad_shape",
           "depthwise_conv3d", "conv_transpose", "to_nchw", "to_nhwc",
           "to_ncdhw", "to_ndhwc"]
