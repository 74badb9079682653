"""Large-Kernel Attention (LKA) chain, plain PyTorch.

Port of `deformablelka_tpu/ops/lka.py`: the LKA gate is
x · conv1(dw7-dil3(dw5(x))), in 3D (5³, 7³) and in 2D (5², 7²).
`dw_chain3d` and `dw_chain2d` here are the plain forms of the two
depthwise stages: the CPU paths of `ops.kernels.dw_chain3d` and
`ops.kernels.dw_chain2d` and the references their CUDA kernels are held
against on the card. `dw_chain3d_backward` is the 3D chain's gradient
written out, the CPU path of `ops.kernels.dw_chain3d_bwd`.

Weights are in the JAX layouts: w_dw (5, 5, [5,] 1, C), w_dil (7, 7,
[7,] 1, C), w_pw (1, 1, [1,] C, C); activations (B, [D,] H, W, C).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deformablelka_tpu_torch.ops.convs import (conv2d, conv3d,
                                               depthwise_conv2d,
                                               depthwise_conv3d)


def _torch_layout(w):
    """(k..., Cin/g, Cout) → (Cout, Cin/g, k...)."""
    n = w.ndim
    return w.permute(n - 1, n - 2, *range(n - 2))


def dw_chain3d(x, w_dw, b_dw, w_dil, b_dil):
    """dw5³ (pad 2) + bias → dw7³ dilation 3 (pad 9) + bias."""
    attn = depthwise_conv3d(x, _torch_layout(w_dw), b_dw, padding=2)
    return depthwise_conv3d(attn, _torch_layout(w_dil), b_dil, padding=9,
                            dilation=3)


def _tap_sums(p, h, k: int, dil: int):
    """(k³, C): for each tap t of a k³ kernel of dilation `dil` (row-major),
    Σ over the batch and the volume of p(v + dil·(t − k // 2)) · h(v), p
    zero outside the volume."""
    B, D, H, W, C = p.shape
    r = dil * (k // 2)
    pp = F.pad(p, (0, 0, r, r, r, r, r, r))
    taps = range(0, 2 * r + 1, dil)
    return torch.stack([(pp[:, z:z + D, y:y + H, x:x + W] * h).sum((0, 1, 2, 3))
                        for z in taps for y in taps for x in taps])


def dw_chain3d_backward(x, w_dw, b_dw, w_dil, b_dil, g):
    """(dx, dw_dw, db_dw, dw_dil, db_dil) of `dw_chain3d` at the cotangent g
    (B, D, H, W, C). With a = dw5(x) + b_dw and y = dil7(a) + b_dil:
    db_dil = Σ g; dw_dil[t] = Σ_v a(v + 3(t − 3)) · g(v); da = dil7ᵀ(g),
    the dilated correlation with flipped taps, zero outside the volume;
    db_dw = Σ da; dw_dw[t] = Σ_v x(v + t − 2) · da(v); dx = dw5ᵀ(da). The
    transposed convs run in reverse order: the zero padding between the two
    convs makes the chain's order matter at the borders."""
    flipped = lambda w: _torch_layout(w).flip(2, 3, 4)
    a = depthwise_conv3d(x, _torch_layout(w_dw), b_dw, padding=2)
    db_dil = g.sum((0, 1, 2, 3))
    dw_dil = _tap_sums(a, g, 7, 3).reshape(w_dil.shape)
    da = depthwise_conv3d(g, flipped(w_dil), padding=9, dilation=3)
    db_dw = da.sum((0, 1, 2, 3))
    dw_dw = _tap_sums(x, da, 5, 1).reshape(w_dw.shape)
    dx = depthwise_conv3d(da, flipped(w_dw), padding=2)
    return dx, dw_dw, db_dw, dw_dil, db_dil


def dw_chain2d(x, w_dw, b_dw, w_dil, b_dil):
    """dw5² (pad 2) + bias → dw7² dilation 3 (pad 9) + bias."""
    attn = depthwise_conv2d(x, _torch_layout(w_dw), b_dw, padding=2)
    return depthwise_conv2d(attn, _torch_layout(w_dil), b_dil, padding=9,
                            dilation=3)


def lka3d(x, w_dw, b_dw, w_dil, b_dil, w_pw, b_pw):
    """3D LKA gate: x · conv1³(dw7³-dil3(dw5³(x))); the chain goes
    through the kernel wrapper, so a CUDA tensor takes the kernel."""
    from deformablelka_tpu_torch.ops import kernels
    attn = kernels.dw_chain3d(x, w_dw, b_dw, w_dil, b_dil)
    return x * conv3d(attn, _torch_layout(w_pw), b_pw)


def lka2d(x, w_dw, b_dw, w_dil, b_dil, w_pw, b_pw):
    """2D LKA gate: x · conv1²(dw7²-dil3(dw5²(x))); the chain goes
    through the kernel wrapper, so a CUDA tensor takes the kernel."""
    from deformablelka_tpu_torch.ops import kernels
    attn = kernels.dw_chain2d(x, w_dw, b_dw, w_dil, b_dil)
    return x * conv2d(attn, _torch_layout(w_pw), b_pw)
