"""The dilated 3D depthwise conv, plain PyTorch, and where it runs.

Port of `deformablelka_tpu/ops/pallas/dwconv3d_kernel.py`
`depthwise_conv3d_pallas` as a function: a depthwise K³ conv, stride 1,
dilation `dil`, padding dil·(K // 2) on every side (zero outside the
volume), plus the bias. `depthwise_conv3d_dilated` is the CPU path of
`ops.kernels.dwconv3d` and the reference its CUDA kernel is held against
on the card.

`dwconv3d_site` is the condition under which the JAX package's `conv3d`
(`ops/convs.py:211-216`) sends a conv to that TPU kernel: the port's
modules launch the CUDA kernel exactly there.
"""

from __future__ import annotations

from deformablelka_tpu_torch.ops.convs import _tuple, depthwise_conv3d, same_padding


def depthwise_conv3d_dilated(x, w, bias, dil: int):
    """x (B, D, H, W, C), w (K, K, K, 1, C) in the JAX layout, bias (C,)
    or None → (B, D, H, W, C)."""
    K = w.shape[0]
    return depthwise_conv3d(x, w.permute(4, 3, 0, 1, 2), bias,
                            padding=dil * (K // 2), dilation=dil)


def dwconv3d_site(w_shape, stride, padding, dilation, groups: int, C: int) -> bool:
    """True where a 3D conv with weight `w_shape` (kd, kh, kw, Cin/g, Cout)
    on C input channels is a dilated depthwise K³ conv with 'same'
    padding: dilation uniform and > 1, stride 1, groups = C, one input
    channel per group, a cubic odd kernel, padding dil·(K // 2). `padding`
    is "same", an int, three ints or three (lo, hi) pairs."""
    st = _tuple(stride, 3)
    dil = _tuple(dilation, 3)
    if padding == "same":
        padding = same_padding(tuple(w_shape[:3]), st, dil, ndim=3)
    elif isinstance(padding, int):
        padding = [(padding, padding)] * 3
    elif isinstance(padding[0], int):
        padding = [(p, p) for p in padding]
    k = w_shape[0]
    return (dil[0] > 1 and dil == (dil[0],) * 3 and st == (1, 1, 1)
            and groups == C and w_shape[3] == 1
            and tuple(w_shape[:3]) == (k, k, k) and k % 2 == 1
            and tuple(map(tuple, padding)) == ((dil[0] * (k // 2),) * 2,) * 3)
