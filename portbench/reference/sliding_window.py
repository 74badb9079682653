"""Plain sliding-window inference over a volume, frozen: nnUNet's grid of
patch origins for a step of `step` patches, a Gaussian importance map
(σ = patch / 8, peak 1, zeros raised to the least non-zero value), every
mirror flip of a tile in one batch, the softmax averaged over the flips,
blended into a numerator and a denominator. Returns the class
probabilities; the caller takes their argmax."""

from __future__ import annotations

import numpy as np
import torch
from scipy.ndimage import gaussian_filter


def origins(patch, shape, step: float) -> list:
    per_axis = []
    for p, s in zip(patch, shape):
        n = int(np.ceil((s - p) / (p * step))) + 1
        span = (s - p) / (n - 1) if n > 1 else 0.0
        per_axis.append([int(np.round(span * i)) for i in range(n)])
    return [(a, b, c) for a in per_axis[0] for b in per_axis[1] for c in per_axis[2]]


def gaussian(patch) -> np.ndarray:
    g = np.zeros(patch)
    g[tuple(p // 2 for p in patch)] = 1
    g = gaussian_filter(g, [p / 8 for p in patch], 0, mode="constant", cval=0)
    g = (g / g.max()).astype(np.float32)
    g[g == 0] = g[g != 0].min()
    return g


FLIPS = [(), (2,), (3,), (2, 3), (4,), (2, 4), (3, 4), (2, 3, 4)]


def probabilities(logits_fn, volume: torch.Tensor, patch, step: float,
                  num_classes: int) -> torch.Tensor:
    """volume (D, H, W) on the device → probabilities (D, H, W, C).
    `logits_fn` maps (8, 1, *patch) to (8, C, *patch)."""
    shape = tuple(volume.shape)
    if any(s < p for s, p in zip(shape, patch)):
        raise ValueError("the volume is smaller than the patch")
    tiles = origins(patch, shape, step)
    gauss = torch.from_numpy(gaussian(patch) if len(tiles) > 1
                             else np.ones(patch, np.float32)).to(volume.device)
    num = torch.zeros(num_classes, *shape, device=volume.device)
    den = torch.zeros(shape, device=volume.device)
    for o in tiles:
        sl = tuple(slice(a, a + p) for a, p in zip(o, patch))
        tile = volume[sl][None, None]
        batch = torch.cat([tile.flip(f) if f else tile for f in FLIPS])
        prob = torch.softmax(logits_fn(batch), dim=1)
        mean = sum(prob[i:i + 1].flip(f) if f else prob[i:i + 1]
                   for i, f in enumerate(FLIPS))[0] / len(FLIPS)
        num[(slice(None),) + sl] += mean * gauss
        den[sl] += gauss
    return (num / den).movedim(0, -1)
