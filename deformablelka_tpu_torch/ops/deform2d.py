"""Exact depthwise 2D deformable convolution, plain PyTorch.

Port of `deform_conv2d` in `deformablelka_tpu/ops/deform2d.py` (the
gather form), for the case the D-LKA gates use: depthwise (groups = C,
one weight per channel and tap), stride 1, one offset group. For each of
the K = kh·kw taps, every output pixel takes a bilinear sample of its
channel at (y − p + i·dil + Δy, x − p + j·dil + Δx) and scales it by that
tap's weight. Each of the 4 corners of a sample contributes zero when it
falls outside the image. There is no clip of the offsets and no branch on
their size. The general grouped conv is not ported (ROADMAP).

Offsets are (B, Ho, Wo, 2·K): channel 2k holds Δy of tap k and 2k + 1
its Δx, taps row-major over (kh, kw). Weights are in the JAX layout
(kh, kw, 1, C).

`deform_dw_conv2d` is the CPU path of `ops.kernels.deform_dw_conv2d` and
the reference its CUDA kernel is held against on the card;
`deform_dw_conv2d_backward`, its autograd, is the same for the backward
kernel (`ops.kernels.deform_dw_conv2d_bwd`). `grid_sample_bilinear` is
the DAT encoder's sampler (no TPU kernel: plain XLA in the JAX package).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from deformablelka_tpu_torch.ops.convs import _tuple


def _bilinear_gather(x_flat, H, W, ys, xs):
    """Sample x_flat (B, H·W, C) at fractional (ys, xs), each (B, P);
    zero outside. Returns (B, P, C)."""
    C = x_flat.shape[-1]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    dy = (ys - y0)[..., None]
    dx = (xs - x0)[..., None]
    y0i, x0i = y0.long(), x0.long()
    out = None
    for oy in (0, 1):
        for ox in (0, 1):
            yi, xi = y0i + oy, x0i + ox
            valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            lin = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
            g = torch.gather(x_flat, 1, lin[..., None].expand(-1, -1, C))
            wy = dy if oy else 1.0 - dy
            wx = dx if ox else 1.0 - dx
            contrib = g * ((wy * wx) * valid[..., None].to(x_flat.dtype))
            out = contrib if out is None else out + contrib
    return out


def deform_conv2d(x, offset, w, bias=None, *, stride=1, padding=0,
                  dilation=1, groups: int = 1):
    """Deformable 2D conv, torchvision semantics, depthwise only.

    x: (B, H, W, C); offset: (B, Ho, Wo, 2·kh·kw); w: (kh, kw, 1, C)
    with groups = C. Returns (B, Ho, Wo, C). Offsets are taken in float32.
    """
    kh, kw, cin_g, cout = w.shape
    B, H, W, C = x.shape
    if not (groups == C and cin_g == 1 and cout == C):
        raise NotImplementedError(
            "only the depthwise deform conv is ported (groups = C, "
            f"w (kh, kw, 1, C)); got groups {groups}, w {tuple(w.shape)}, C {C}")
    if _tuple(stride, 2) != (1, 1):
        raise NotImplementedError("only stride 1 is ported")
    ph, pw = _tuple(padding, 2)
    dh, dw = _tuple(dilation, 2)
    K = kh * kw
    Ho = H + 2 * ph - dh * (kh - 1)
    Wo = W + 2 * pw - dw * (kw - 1)
    if tuple(offset.shape) != (B, Ho, Wo, 2 * K):
        raise ValueError(f"offset shape {tuple(offset.shape)} != "
                         f"{(B, Ho, Wo, 2 * K)}")
    P = Ho * Wo
    dev = x.device
    f32 = torch.float32
    base_y = (torch.arange(Ho, device=dev, dtype=f32) - ph).view(
        Ho, 1).expand(Ho, Wo).reshape(1, P)
    base_x = (torch.arange(Wo, device=dev, dtype=f32) - pw).view(
        1, Wo).expand(Ho, Wo).reshape(1, P)
    off = offset.reshape(B, P, K, 2).to(f32)
    x_flat = x.reshape(B, H * W, C)
    w_k = w.reshape(K, C).to(x.dtype)
    out = torch.zeros(B, P, C, device=dev, dtype=x.dtype)
    for k in range(K):
        i, j = divmod(k, kw)
        ys = base_y + float(i * dh) + off[:, :, k, 0]
        xs = base_x + float(j * dw) + off[:, :, k, 1]
        out = out + _bilinear_gather(x_flat, H, W, ys, xs).to(x.dtype) * w_k[k]
    out = out.reshape(B, Ho, Wo, C)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def deform_dw_conv2d(x, offset, w, dil: int = 1):
    """The kernel's function: depthwise k×k deform conv, stride 1,
    dilation `dil`, padding (k // 2)·dil, no bias. x (B, H, W, C), offset
    (B, H, W, 2k²), w (k, k, 1, C) → (B, H, W, C)."""
    return deform_conv2d(x, offset, w, padding=(w.shape[0] // 2) * dil,
                         dilation=dil, groups=x.shape[-1])


def deform_dw_conv2d_backward(x, offset, w, g, dil: int = 1):
    """(dx, d-offset, dw) of `deform_dw_conv2d(x, offset, w, dil)` at the
    cotangent g: `torch.autograd.grad` of the plain forward. floor has zero
    derivative, so at an integer coordinate the offset gradient is the
    right derivative x(y0 + 1) − x(y0), as in torchvision."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (x, offset, w)]
        y = deform_dw_conv2d(*inputs, dil)
        return torch.autograd.grad(y, inputs, g)


def grid_sample_bilinear(x, grid):
    """torch's `F.grid_sample(mode="bilinear", padding_mode="zeros",
    align_corners=True)` on an NHWC map (the JAX package's
    `grid_sample_bilinear`, plain XLA there). x (B, H, W, C); grid (B, Hg,
    Wg, 2) of (x, y) in [−1, 1] → (B, Hg, Wg, C); each corner outside the
    map contributes zero."""
    out = F.grid_sample(x.permute(0, 3, 1, 2), grid, mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out.permute(0, 2, 3, 1)
