"""Sliding-window volumetric inference with Gaussian blending and mirror TTA.

Port of `deformablelka_tpu/inference/sliding_window.py`: nnUNet's step
grid (`compute_steps`) or the Pancreas tester's stride grid
(`compute_steps_stride`, `grid_mode="stride"`), the Gaussian importance
map or count blending (`use_gaussian=False`), padding up to the patch,
the 2^k mirror flips run `tta_batch` at a time, softmax averaged over the
flips, blended into a numerator and a denominator on the device, and an
argmax on the device whose uint8 result is all that comes back to the
host. One Python loop over the tiles, one tile per forward, takes the
place of the JAX engine's scan, tile batches and shape buckets.

With `mesh=` (a `parallel.Mesh`), the tiles are shared over `mesh_axis`
as the JAX engine shards them (`P(axis)`): the list is cut into equal
contiguous chunks of ceil(n / ranks), each rank blends its own chunk into
its numerator and denominator, and both are summed over the axis
(`all_reduce`) before the division, so every rank returns the same
probabilities. The JAX engine pads the list with weight-0 tiles up to a
multiple of the axis; they add nothing, so the port skips them (the last
ranks may get fewer tiles, or none). Every rank must hold the same
weights (`parallel.replicated`).
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import numpy as np
import torch
import torch.distributed as dist
from scipy.ndimage import gaussian_filter


def compute_steps(patch_size, image_size, step_size: float):
    """nnUNet-compatible sliding-window origins per dim (list of lists)."""
    if not all(i >= j for i, j in zip(image_size, patch_size)):
        raise ValueError("image smaller than the patch; pad it first")
    target = [p * step_size for p in patch_size]
    nsteps = [int(np.ceil((i - p) / t)) + 1
              for i, p, t in zip(image_size, patch_size, target)]
    steps = []
    for dim in range(len(patch_size)):
        span = image_size[dim] - patch_size[dim]
        actual = span / (nsteps[dim] - 1) if nsteps[dim] > 1 else 1e13
        steps.append([int(np.round(actual * i)) for i in range(nsteps[dim])])
    return steps


def compute_steps_stride(patch_size, image_size, stride_xy: int,
                         stride_z: int):
    """The Pancreas tester's step grid (upstream's test_util.py:75-85): per
    dim, ceil((size-patch)/stride)+1 steps at min(stride*i, size-patch):
    the last origin is clamped to the border, and the tiles' overlaps are
    normalised by count blending, as upstream's repeated accumulation
    does."""
    strides = (stride_xy, stride_xy, stride_z)
    steps = []
    for dim in range(3):
        span = image_size[dim] - patch_size[dim]
        n = int(np.ceil(span / strides[dim])) + 1 if span > 0 else 1
        steps.append([min(strides[dim] * i, span) for i in range(n)])
    return steps


@functools.lru_cache(maxsize=8)
def gaussian_importance_map(patch_size: Tuple[int, ...],
                            sigma_scale: float = 1.0 / 8) -> np.ndarray:
    """Centre delta filtered with σ = patch·sigma_scale, max 1, zeros
    replaced by the smallest nonzero value. Cached: do not modify."""
    tmp = np.zeros(patch_size)
    tmp[tuple(p // 2 for p in patch_size)] = 1
    g = gaussian_filter(tmp, [p * sigma_scale for p in patch_size], 0,
                        mode="constant", cval=0)
    g = (g / g.max()).astype(np.float32)
    g[g == 0] = g[g != 0].min()
    return g


def pad_to_min(x: np.ndarray, patch_size) -> Tuple[np.ndarray, list]:
    """Pad the leading (spatial) dims of x up to patch_size, split evenly,
    with zeros. Returns the padded array and the slicer that undoes it."""
    shape = x.shape[:len(patch_size)]
    new_shape = [max(s, p) for s, p in zip(shape, patch_size)]
    diff = [n - s for n, s in zip(new_shape, shape)]
    lo = [d // 2 for d in diff]
    pads = ([(l, d - l) for l, d in zip(lo, diff)]
            + [(0, 0)] * (x.ndim - len(shape)))
    xp = np.pad(x, pads, mode="constant")
    slicer = [slice(l, l + s) for l, s in zip(lo, shape)]
    return xp, slicer


def tta_combos(mirror_axes, do_mirroring: bool):
    """The flip combinations in nnUNet's order: () then every non-empty
    subset of mirror_axes, by bitmask."""
    combos = [()]
    if do_mirroring:
        for m in range(1, 2 ** len(mirror_axes)):
            combos.append(tuple(a for i, a in enumerate(mirror_axes)
                                if (m >> i) & 1))
    return combos


def mirror_tta_softmax(apply_fn: Callable, tile: torch.Tensor, mirror_axes,
                       do_mirroring: bool, tta_batch: int = 1):
    """Softmax averaged over the flips of one tile, (1, *patch, C) →
    (*patch, ncls) in float32, `tta_batch` flips per forward."""
    combos = tta_combos(mirror_axes, do_mirroring)
    b = max(1, min(int(tta_batch), len(combos)))
    while len(combos) % b:
        b -= 1

    def head(logits):
        if isinstance(logits, (list, tuple)):
            logits = logits[0]
        return torch.softmax(logits.float(), dim=-1)

    acc = None
    for i in range(0, len(combos), b):
        chunk = combos[i:i + b]
        batch = torch.cat([torch.flip(tile, [a + 1 for a in c]) if c else tile
                           for c in chunk]).contiguous()
        prob = head(apply_fn(batch))
        prob = sum(torch.flip(prob[j], list(c)) if c else prob[j]
                   for j, c in enumerate(chunk))
        acc = prob if acc is None else acc + prob
    return acc / len(combos)


class SlidingWindowInference:
    """Tiled 3D prediction on one device, or over the ranks of a mesh axis.

    `apply_fn(x)` maps a (b, *patch, C) float32 tensor to logits
    (b, *patch, ncls), or to a deep-supervision list whose first entry is
    used. Volumes are (S1, S2, S3, C) numpy arrays on the host.
    `grid_mode`: "nnunet", the evenly spaced overlap grid of `step_size`
    (upstream's neural_network.py:267-290), or "stride", the Pancreas
    tester's grid of fixed strides `stride_xy`, `stride_xy`, `stride_z`,
    clamped at the border (test_util.py:75-111). `mesh`, `mesh_axis`: share
    the tiles over that axis of a `parallel.Mesh` (the module docstring);
    the engine then runs on the mesh's device.
    """

    def __init__(self, apply_fn: Callable, patch_size, num_classes: int,
                 step_size: float = 0.5, do_mirroring: bool = True,
                 mirror_axes=(0, 1, 2), use_gaussian: bool = True,
                 tta_batch: int = 1, grid_mode: str = "nnunet",
                 stride_xy: int = 16, stride_z: int = 16, device="cuda",
                 mesh=None, mesh_axis: str = "data"):
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        if mesh is not None:
            device = mesh.device
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run "
                               "on the CPU")
        self.apply_fn = apply_fn
        self.patch_size = tuple(patch_size)
        self.num_classes = num_classes
        self.step_size = step_size
        self.do_mirroring = do_mirroring
        self.mirror_axes = tuple(mirror_axes)
        self.use_gaussian = use_gaussian
        self.tta_batch = tta_batch
        if grid_mode not in ("nnunet", "stride"):
            raise ValueError(f"grid_mode {grid_mode!r}: 'nnunet' or 'stride'")
        self.grid_mode = grid_mode
        self.stride_xy = stride_xy
        self.stride_z = stride_z

    def origins(self, padded_shape):
        if self.grid_mode == "stride":
            steps = compute_steps_stride(self.patch_size, padded_shape,
                                         self.stride_xy, self.stride_z)
        else:
            steps = compute_steps(self.patch_size, padded_shape,
                                  self.step_size)
        return [(a, b, c) for a in steps[0] for b in steps[1]
                for c in steps[2]]

    def local_origins(self, origins):
        """This rank's contiguous chunk of the tile list (all of it without
        a mesh): chunks of ceil(n / ranks), as `P(axis)` cuts the list that
        the JAX engine pads with weight-0 tiles, which are skipped here."""
        if self.mesh is None:
            return origins
        n_rank = self.mesh.size(self.mesh_axis)
        per = -(-len(origins) // n_rank)
        i = self.mesh.coordinate(self.mesh_axis)
        return origins[i * per:(i + 1) * per]

    @torch.no_grad()
    def predict(self, volume: np.ndarray, do_mirroring: bool | None = None,
                return_device: bool = False):
        """Class probabilities (S1, S2, S3, ncls) on the host, padding
        removed; with `return_device`, the padded device tensor and the
        crop slicer instead. `do_mirroring` overrides the engine's setting
        for this call only."""
        if do_mirroring is None:
            do_mirroring = self.do_mirroring
        data, slicer = pad_to_min(volume.astype(np.float32, copy=False),
                                  self.patch_size)
        padded_shape = data.shape[:3]
        origins = self.origins(padded_shape)
        if self.use_gaussian and len(origins) > 1:
            gauss = gaussian_importance_map(self.patch_size)
        else:
            gauss = np.ones(self.patch_size, np.float32)
        dev = self.device
        data = torch.from_numpy(data).to(dev)
        gauss = torch.from_numpy(gauss).to(dev)
        num = torch.zeros(*padded_shape, self.num_classes, device=dev)
        den = torch.zeros(padded_shape, device=dev)
        for o in self.local_origins(origins):
            sl = tuple(slice(s, s + p) for s, p in zip(o, self.patch_size))
            prob = mirror_tta_softmax(self.apply_fn, data[sl][None],
                                      self.mirror_axes, do_mirroring,
                                      self.tta_batch)
            num[sl] += prob * gauss[..., None]
            den[sl] += gauss
        if self.mesh is not None:
            group = self.mesh.group(self.mesh_axis)
            dist.all_reduce(num, group=group)
            dist.all_reduce(den, group=group)
        probs = num / den[..., None]
        if return_device:
            return probs, tuple(slicer)
        return probs.cpu().numpy()[tuple(slicer)]

    def predict_segmentation(self, volume: np.ndarray) -> np.ndarray:
        """Argmax on the device; only the uint8 labels come to the host."""
        probs, slicer = self.predict(volume, return_device=True)
        labels = torch.argmax(probs, dim=-1).to(torch.uint8)
        return labels.cpu().numpy()[slicer]
