"""CT-like inputs made on the device from a seed, in a few large draws.

A case is an elliptic body of soft tissue with a smooth texture, holding
`num_classes − 1` organ ellipsoids (ellipses in 2D) of their own
intensities, later organs over earlier ones, plus fine grain noise:
intensities in [0, 1] before the caller normalises them. The label map
marks each organ with its index and the rest with 0. The same seed gives
the same cases; every seed gives cases of the same sizes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _smooth(x, passes: int = 2):
    pool = F.avg_pool3d if x.ndim == 5 else F.avg_pool2d
    for _ in range(passes):
        x = pool(x, 5, 1, 2)
    return x


def organs(n: int, shape, num_classes: int, seed: int, device):
    """(images (n, *shape) in [0, 1], labels (n, *shape) int64)."""
    g = torch.Generator(device=device).manual_seed(seed)
    nd, K = len(shape), num_classes - 1
    axes = [torch.linspace(-1, 1, s, device=device) for s in shape]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij"))            # (nd, *shape)
    texture = _smooth(torch.randn((n, 1, *shape), generator=g, device=device))[:, 0]
    texture = texture / texture.std() * 0.05
    centres = torch.rand((n, K, nd), generator=g, device=device) - 0.5
    radii = 0.08 + 0.17 * torch.rand((n, K, nd), generator=g, device=device)
    levels = 0.4 + 0.5 * torch.rand((n, K), generator=g, device=device)
    grain = 0.02 * torch.randn((n, *shape), generator=g, device=device)
    body = ((grid / 0.9) ** 2).sum(0) < 1
    image = torch.where(body, 0.35 + texture, torch.zeros_like(texture))
    label = torch.zeros((n, *shape), dtype=torch.int64, device=device)
    for k in range(K):
        c = centres[:, k].reshape(n, nd, *(1,) * nd)
        r = radii[:, k].reshape(n, nd, *(1,) * nd)
        inside = body & ((((grid[None] - c) / r) ** 2).sum(1) < 1)
        label = torch.where(inside, k + 1, label)
        lv = levels[:, k].reshape(n, *(1,) * nd)
        image = torch.where(inside, lv + texture, image)
    return (image + grain).clamp_(0, 1), label


def zscore(images):
    """Each case to mean 0 and standard deviation 1, as nnUNet's CT
    preprocessing leaves it."""
    dims = tuple(range(1, images.ndim))
    mean = images.mean(dims, keepdim=True)
    return (images - mean) / images.std(dims, keepdim=True)
