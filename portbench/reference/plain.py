"""Plain PyTorch operations the references share: the deformable
convolutions written out as gathers, the depthwise chain on `F.conv3d`,
and the losses.

Everything here is channels-first (B, C, *S) and float32. The hand-kernel
stand-ins are called through `KERNELS`, so that `portbench.counts` can put
counting versions in their place while it walks a reference on the meta
device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _corner_samples(x_cl, sizes, coords):
    """Multilinear samples of x_cl (B, V, C), a channels-last map of
    spatial `sizes`, at the fractional coordinates `coords` (one (B, P)
    tensor per axis). Each corner outside the map contributes zero.
    Returns (B, P, C)."""
    B, V, C = x_cl.shape
    P = coords[0].shape[1]
    nd = len(sizes)
    lows = [torch.floor(c) for c in coords]
    fracs = [c - lo for c, lo in zip(coords, lows)]
    lows = [lo.long() for lo in lows]
    idx, wts = [], []
    for corner in range(2 ** nd):
        lin = torch.zeros_like(lows[0])
        w = torch.ones_like(fracs[0])
        valid = torch.ones_like(lows[0], dtype=torch.bool)
        for a in range(nd):
            bit = (corner >> (nd - 1 - a)) & 1
            i = lows[a] + bit
            valid = valid & (i >= 0) & (i < sizes[a])
            lin = lin * sizes[a] + i.clamp(0, sizes[a] - 1)
            w = w * (fracs[a] if bit else 1.0 - fracs[a])
        idx.append(lin)
        wts.append(w * valid)
    idx = torch.stack(idx, 2).reshape(B, P * 2 ** nd)
    wts = torch.stack(wts, 2).reshape(B, P, 2 ** nd, 1)
    g = torch.gather(x_cl, 1, idx[..., None].expand(B, P * 2 ** nd, C))
    return (g.reshape(B, P, 2 ** nd, C) * wts).sum(2)


def _base_grid(sizes, pads, dils, taps, device):
    """Per tap, the undeformed sample coordinate of every output position
    (stride 1): a list over taps of per-axis (1, P) tensors."""
    axes = [torch.arange(s, device=device, dtype=torch.float32) for s in sizes]
    mesh = torch.meshgrid(*axes, indexing="ij")
    flat = [m.reshape(1, -1) for m in mesh]
    return [[flat[a] - pads[a] + t[a] * dils[a] for a in range(len(sizes))] for t in taps]


def _taps(kernel):
    out = [()]
    for k in kernel:
        out = [t + (i,) for t in out for i in range(k)]
    return out


def deform_conv3d(x, offset, weight, bias):
    """3³ deformable conv, stride 1, padding 1, groups 1. x (B, C, D, H,
    W); offset (B, 81, D, H, W), channel 3k + a the tap k's shift along
    axis a (d, h, w), taps row-major over (kd, kh, kw); weight (Co, C, 3,
    3, 3); bias (Co,). Every output voxel takes, per tap, a trilinear
    sample at (z − 1 + i + Δd, y − 1 + j + Δh, x − 1 + m + Δw) and mixes
    channels with that tap's weight."""
    B, C, D, H, W = x.shape
    Co = weight.shape[0]
    sizes = (D, H, W)
    x_cl = x.permute(0, 2, 3, 4, 1).reshape(B, D * H * W, C)
    off = offset.reshape(B, 27, 3, D * H * W)
    taps = _taps((3, 3, 3))
    base = _base_grid(sizes, (1, 1, 1), (1, 1, 1), taps, x.device)
    out = None
    for k, t in enumerate(taps):
        coords = [base[k][a] + off[:, k, a] for a in range(3)]
        samp = _corner_samples(x_cl, sizes, coords)
        term = samp @ weight[:, :, t[0], t[1], t[2]].t()
        out = term if out is None else out + term
    out = out + bias
    return out.reshape(B, D, H, W, Co).permute(0, 4, 1, 2, 3)


def deform_dw_conv2d(x, offset, weight, dil):
    """Depthwise k×k deformable conv, stride 1, dilation `dil`, padding
    (k // 2)·dil, no bias. x (B, C, H, W); offset (B, 2k², H, W), channel
    2k + a the tap k's shift along axis a (y, x), taps row-major; weight
    (C, 1, k, k)."""
    B, C, H, W = x.shape
    k = weight.shape[-1]
    x_cl = x.permute(0, 2, 3, 1).reshape(B, H * W, C)
    off = offset.reshape(B, k * k, 2, H * W)
    taps = _taps((k, k))
    pad = (k // 2) * dil
    base = _base_grid((H, W), (pad, pad), (dil, dil), taps, x.device)
    out = None
    for n, t in enumerate(taps):
        coords = [base[n][a] + off[:, n, a] for a in range(2)]
        term = _corner_samples(x_cl, (H, W), coords) * weight[:, 0, t[0], t[1]]
        out = term if out is None else out + term
    return out.reshape(B, H, W, C).permute(0, 3, 1, 2)


def dw_chain3d(x, w5, b5, w7, b7):
    """Depthwise 5³ (pad 2) then depthwise 7³ dilation 3 (pad 9), each
    with its bias."""
    C = x.shape[1]
    y = F.conv3d(x, w5, b5, padding=2, groups=C)
    return F.conv3d(y, w7, b7, padding=9, dilation=3, groups=C)


# The functions that stand where the program runs a hand kernel.
KERNELS = {"deform_conv3d": deform_conv3d, "dw_chain3d": dw_chain3d,
           "deform_dw_conv2d": deform_dw_conv2d}


def one_hot(labels, num_classes):
    """labels (B, *S) int → (B, C, *S) float32."""
    classes = torch.arange(num_classes, device=labels.device)
    shape = (1, num_classes) + (1,) * (labels.ndim - 1)
    return (labels[:, None] == classes.view(shape)).float()


def cross_entropy(logits, labels):
    """Mean over voxels of −log softmax at the label; logits (B, C, *S)."""
    logp = torch.log_softmax(logits, dim=1)
    return -torch.gather(logp, 1, labels[:, None].long()).mean()


def soft_dice_batch(logits, labels):
    """nnUNet's soft Dice loss: per class over the batch and space,
    background left out, smooth 1e-5."""
    C = logits.shape[1]
    p = torch.softmax(logits, dim=1)
    y = one_hot(labels, C)
    axes = (0,) + tuple(range(2, logits.ndim))
    tp = (p * y).sum(axes)
    fp = (p * (1 - y)).sum(axes)
    fn = ((1 - p) * y).sum(axes)
    dc = (2 * tp + 1e-5) / (2 * tp + fp + fn + 1e-5)
    return -dc[1:].mean()


def deep_supervision_loss(outputs, labels):
    """Σ_i w_i (CE + Dice) of output i against the labels taken every
    f-th voxel, w_i ∝ 1/2^i normalised to sum 1."""
    w = [1 / 2 ** i for i in range(len(outputs))]
    total = 0.0
    for wi, out in zip(w, outputs):
        f = [a // b for a, b in zip(labels.shape[1:], out.shape[2:])]
        lab = labels[(slice(None),) + tuple(slice(None, None, s) for s in f)]
        total = total + wi / sum(w) * (cross_entropy(out, lab) + soft_dice_batch(out, lab))
    return total


def dice_ce_2d_loss(logits, labels):
    """0.4·CE + 0.6·(1 − mean over classes of the squared soft Dice),
    each class over the whole batch, background included, smooth 1e-5."""
    C = logits.shape[1]
    p = torch.softmax(logits, dim=1)
    y = one_hot(labels, C)
    axes = (0, 2, 3)
    inter = (p * y).sum(axes)
    dice = (2 * inter + 1e-5) / ((p * p).sum(axes) + (y * y).sum(axes) + 1e-5)
    return 0.4 * cross_entropy(logits, labels) + 0.6 * (1 - dice.mean())
