"""Exact 3D deformable convolution, plain PyTorch.

Port of `deform_conv3d` in `deformablelka_tpu/ops/deform3d.py` (the
gather form): for each of the K = kd·kh·kw taps, every output voxel takes
a trilinear sample of the input at (z·s − p + i·dil + Δd, y·s − p + j·dil
+ Δh, x·s − p + m·dil + Δw) and mixes channels with that tap's weight.
Each of the 8 corners of a sample contributes zero when it falls outside
the volume. There is no clip of the offsets and no branch on their size.

This is the CPU path of `ops.kernels.deform_conv3d` and the reference the
CUDA kernel is held against on the card; `deform_conv3d_backward`, its
autograd gradient, is the same for the backward kernel.
"""

from __future__ import annotations

import torch

from deformablelka_tpu_torch.ops.convs import _tuple


def _trilinear_gather(x_flat, D, H, W, zs, ys, xs):
    """Sample x_flat (B, D·H·W, C) at fractional (zs, ys, xs), each (B, P);
    zero outside. Returns (B, P, C)."""
    C = x_flat.shape[-1]
    z0, y0, x0 = torch.floor(zs), torch.floor(ys), torch.floor(xs)
    dz = (zs - z0)[..., None]
    dy = (ys - y0)[..., None]
    dx = (xs - x0)[..., None]
    z0i, y0i, x0i = z0.long(), y0.long(), x0.long()
    out = None
    for oz in (0, 1):
        for oy in (0, 1):
            for ox in (0, 1):
                zi, yi, xi = z0i + oz, y0i + oy, x0i + ox
                valid = ((zi >= 0) & (zi < D) & (yi >= 0) & (yi < H)
                         & (xi >= 0) & (xi < W))
                lin = ((zi.clamp(0, D - 1) * H + yi.clamp(0, H - 1)) * W
                       + xi.clamp(0, W - 1))
                g = torch.gather(x_flat, 1, lin[..., None].expand(-1, -1, C))
                wz = dz if oz else 1.0 - dz
                wy = dy if oy else 1.0 - dy
                wx = dx if ox else 1.0 - dx
                w = (wz * wy * wx) * valid[..., None].to(x_flat.dtype)
                contrib = g * w
                out = contrib if out is None else out + contrib
    return out


def deform_conv3d(x, offset, w, bias=None, *, stride=1, padding=1,
                  dilation=1):
    """Deformable 3D conv, D3D semantics, groups 1.

    x: (B, D, H, W, Cin); offset: (B, Do, Ho, Wo, 3·K), where channel
    3k + i holds tap k, axis i in (d, h, w) order, taps row-major over
    (kd, kh, kw); w: (kd, kh, kw, Cin, Cout). Returns (B, Do, Ho, Wo,
    Cout). Computes in x's dtype; offsets are taken in float32.
    """
    kd, kh, kw, cin, cout = w.shape
    B, D, H, W, C = x.shape
    if cin != C:
        raise ValueError(f"weight takes {cin} channels, input has {C}")
    sd, sh, sw = _tuple(stride, 3)
    pd, ph, pw = _tuple(padding, 3)
    dd, dh, dw = _tuple(dilation, 3)
    K = kd * kh * kw
    Do = (D + 2 * pd - dd * (kd - 1) - 1) // sd + 1
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    if tuple(offset.shape) != (B, Do, Ho, Wo, 3 * K):
        raise ValueError(f"offset shape {tuple(offset.shape)} != "
                         f"{(B, Do, Ho, Wo, 3 * K)}")
    P = Do * Ho * Wo
    dev = x.device
    f32 = torch.float32
    base_z = (torch.arange(Do, device=dev, dtype=f32) * sd - pd).view(
        Do, 1, 1).expand(Do, Ho, Wo).reshape(1, P)
    base_y = (torch.arange(Ho, device=dev, dtype=f32) * sh - ph).view(
        1, Ho, 1).expand(Do, Ho, Wo).reshape(1, P)
    base_x = (torch.arange(Wo, device=dev, dtype=f32) * sw - pw).view(
        1, 1, Wo).expand(Do, Ho, Wo).reshape(1, P)
    off = offset.reshape(B, P, K, 3).to(f32)
    x_flat = x.reshape(B, D * H * W, C)
    w_k = w.reshape(K, cin, cout)
    out = torch.zeros(B, P, cout, device=dev, dtype=x.dtype)
    k = 0
    for i in range(kd):
        for j in range(kh):
            for m in range(kw):
                zs = base_z + float(i * dd) + off[:, :, k, 0]
                ys = base_y + float(j * dh) + off[:, :, k, 1]
                xs = base_x + float(m * dw) + off[:, :, k, 2]
                samp = _trilinear_gather(x_flat, D, H, W, zs, ys, xs)
                out = out + samp.to(x.dtype) @ w_k[k].to(x.dtype)
                k += 1
    out = out.reshape(B, Do, Ho, Wo, cout)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def deform_conv3d_backward(x, offset, w, g):
    """(dx, d-offset, dw) of `deform_conv3d(x, offset, w)` (3³, stride 1,
    pad 1) at the cotangent g: `torch.autograd.grad` of the plain forward.
    floor has zero derivative, so at an integer coordinate the offset
    gradient is the right derivative x(z0 + 1) − x(z0), as in D3D."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (x, offset, w)]
        y = deform_conv3d(*inputs)
        return torch.autograd.grad(y, inputs, g)
