"""Large-Kernel Attention (LKA) chain, plain PyTorch.

Port of `deformablelka_tpu/ops/lka.py`: the 3D LKA gate is
x · conv1³(dw7³-dil3(dw5³(x))). `dw_chain3d` here is the plain form of the
two depthwise stages: the CPU path of `ops.kernels.dw_chain3d` and the
reference its CUDA kernel is held against on the card.

Weights are in the JAX layouts: w_dw (5, 5, 5, 1, C), w_dil (7, 7, 7, 1,
C), w_pw (1, 1, 1, C, C); activations (B, D, H, W, C).
"""

from __future__ import annotations

from deformablelka_tpu_torch.ops.convs import conv3d, depthwise_conv3d


def _torch_layout(w):
    """(kd, kh, kw, Cin/g, Cout) → (Cout, Cin/g, kd, kh, kw)."""
    return w.permute(4, 3, 0, 1, 2)


def dw_chain3d(x, w_dw, b_dw, w_dil, b_dil):
    """dw5³ (pad 2) + bias → dw7³ dilation 3 (pad 9) + bias."""
    attn = depthwise_conv3d(x, _torch_layout(w_dw), b_dw, padding=2)
    return depthwise_conv3d(attn, _torch_layout(w_dil), b_dil, padding=9,
                            dilation=3)


def lka3d(x, w_dw, b_dw, w_dil, b_dil, w_pw, b_pw):
    """3D LKA gate: x · conv1³(dw7³-dil3(dw5³(x))); the chain goes
    through the kernel wrapper, so a CUDA tensor takes the kernel."""
    from deformablelka_tpu_torch.ops import kernels
    attn = kernels.dw_chain3d(x, w_dw, b_dw, w_dil, b_dil)
    return x * conv3d(attn, _torch_layout(w_pw), b_pw)
