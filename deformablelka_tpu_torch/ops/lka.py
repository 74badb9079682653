"""Large-Kernel Attention (LKA) chain, plain PyTorch.

Port of `deformablelka_tpu/ops/lka.py`: the LKA gate is
x · conv1(dw7-dil3(dw5(x))), in 3D (5³, 7³) and in 2D (5², 7²).
`dw_chain3d` and `dw_chain2d` here are the plain forms of the two
depthwise stages: the CPU paths of `ops.kernels.dw_chain3d` and
`ops.kernels.dw_chain2d` and the references their CUDA kernels are held
against on the card.

Weights are in the JAX layouts: w_dw (5, 5, [5,] 1, C), w_dil (7, 7,
[7,] 1, C), w_pw (1, 1, [1,] C, C); activations (B, [D,] H, W, C).
"""

from __future__ import annotations

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
