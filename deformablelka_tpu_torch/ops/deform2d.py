"""Exact 2D deformable convolution, plain PyTorch.

Port of `deform_conv2d` in `deformablelka_tpu/ops/deform2d.py` (the
gather form), torchvision's `DeformConv2d` semantics: any `groups` from 1
to C, `stride`, `padding` and `dilation`, one offset group. For each of
the K = kh·kw taps, every output pixel takes a bilinear sample of the
input at (y·s − p + i·dil + Δy, x·s − p + j·dil + Δx); each of the 4
corners of a sample contributes zero when it falls outside the image.
The depthwise case (groups = C, one weight per channel and tap) scales
each channel's samples by its tap weight; the others mix each group's
Cin / groups sampled channels into its Cout / groups outputs with one
einsum per tap and group, as the JAX function does. There is no clip of
the offsets and no branch on their size. Gradients are autograd's of the
gather: floor has zero derivative, so at an integer coordinate the offset
gradient is the right derivative x(y0 + 1) − x(y0), as `jax.grad` of the
JAX gather and torchvision give.

Offsets are (B, Ho, Wo, 2·K): channel 2k holds Δy of tap k and 2k + 1
its Δx, taps row-major over (kh, kw). Weights are in the JAX layout
(kh, kw, Cin / groups, Cout).

`deform_conv2d` on a CUDA tensor sends the D-LKA gates' case (depthwise,
square odd kernel, stride 1, 'same' padding (k // 2)·dil) to the hand
kernel `ops.kernels.deform_dw_conv2d` (and adds the bias); every other
case, and every CPU tensor, takes the plain gather (JAX computes them in
XLA, outside any Pallas kernel, and no model calls them).
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


def deform_conv2d_gather(x, offset, w, bias=None, *, stride=1, padding=0,
                         dilation=1, groups: int = 1):
    """Deformable 2D conv, the plain gather on any device.

    x: (B, H, W, Cin); offset: (B, Ho, Wo, 2·kh·kw); w: (kh, kw, Cin //
    groups, Cout). Returns (B, Ho, Wo, Cout). Offsets are taken in float32.
    """
    kh, kw, cin_g, cout = w.shape
    B, H, W, C = x.shape
    if C % groups or cout % groups or cin_g * groups != C:
        raise ValueError(f"w {tuple(w.shape)} and groups {groups} do not fit C {C}")
    sh, sw = _tuple(stride, 2)
    ph, pw = _tuple(padding, 2)
    dh, dw = _tuple(dilation, 2)
    K = kh * kw
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    if tuple(offset.shape) != (B, Ho, Wo, 2 * K):
        raise ValueError(f"offset shape {tuple(offset.shape)} != "
                         f"{(B, Ho, Wo, 2 * K)}")
    P = Ho * Wo
    dev = x.device
    f32 = torch.float32
    base_y = (torch.arange(Ho, device=dev, dtype=f32) * sh - ph).view(
        Ho, 1).expand(Ho, Wo).reshape(1, P)
    base_x = (torch.arange(Wo, device=dev, dtype=f32) * sw - pw).view(
        1, Wo).expand(Ho, Wo).reshape(1, P)
    off = offset.reshape(B, P, K, 2).to(f32)
    x_flat = x.reshape(B, H * W, C)
    depthwise = groups == C and cin_g == 1 and cout == C
    if depthwise:
        w_k = w.reshape(K, C).to(x.dtype)
    else:  # (K, groups, Cin / groups, Cout / groups)
        w_k = w.reshape(K, cin_g, groups, cout // groups).permute(0, 2, 1, 3).to(x.dtype)
    out = torch.zeros(B, P, cout, device=dev, dtype=x.dtype)
    for k in range(K):
        i, j = divmod(k, kw)
        ys = base_y + float(i * dh) + off[:, :, k, 0]
        xs = base_x + float(j * dw) + off[:, :, k, 1]
        samp = _bilinear_gather(x_flat, H, W, ys, xs).to(x.dtype)
        if depthwise:
            out = out + samp * w_k[k]
        else:
            out = out + torch.einsum("bpgc,gco->bpgo", samp.reshape(B, P, groups, cin_g),
                                     w_k[k]).reshape(B, P, cout)
    out = out.reshape(B, Ho, Wo, cout)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def deform_conv2d(x, offset, w, bias=None, *, stride=1, padding=0,
                  dilation=1, groups: int = 1):
    """Deformable 2D conv, torchvision semantics (`deform_conv2d_gather`);
    on a CUDA tensor the depthwise stride-1 'same' case launches kernel 4
    (`ops.kernels.deform_dw_conv2d`)."""
    kh, kw, cin_g, cout = w.shape
    C = x.shape[-1]
    dil = _tuple(dilation, 2)
    if (x.is_cuda and groups == C and cin_g == 1 and cout == C and kh == kw
            and kh % 2 == 1 and dil[0] == dil[1] and _tuple(stride, 2) == (1, 1)
            and _tuple(padding, 2) == ((kh // 2) * dil[0],) * 2):
        from deformablelka_tpu_torch.ops import kernels

        out = kernels.deform_dw_conv2d(x, offset, w, dil[0])
        return out if bias is None else out + bias.to(out.dtype)
    return deform_conv2d_gather(x, offset, w, bias, stride=stride, padding=padding,
                                dilation=dilation, groups=groups)


def deform_dw_conv2d(x, offset, w, dil: int = 1):
    """The kernel's function: depthwise k×k deform conv, stride 1,
    dilation `dil`, padding (k // 2)·dil, no bias. x (B, H, W, C), offset
    (B, H, W, 2k²), w (k, k, 1, C) → (B, H, W, C)."""
    return deform_conv2d_gather(x, offset, w, padding=(w.shape[0] // 2) * dil,
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
