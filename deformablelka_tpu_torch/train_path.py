"""The port's training path, and a device-time breakdown of it.

The training path is the JAX package's flagship training step
(`bench.py:59-106`): `dlka_former_synapse(num_classes=14, do_ds=True,
remat=True)` at full width and depth (21 D-LKA blocks), batch 2 at patch
64×128×128, the deep-supervision Dice + CE loss, SGD with Nesterov momentum
0.99, weight decay 3e-5 and a global-norm clip of 12, lr
`poly_lr(0, 1000, 1e-2)`. Weights are random from a seed; the gates are
driven as `main_path.drive_gates` does (gamma 1, offset-conv weights drawn
from the seed), so the offsets reach past ±1 and the gate gradients are not
scaled by 1e-6. The image is seeded f32 noise and the labels seeded int64
in [0, 14). The step runs in float32, TF32 off where the caller turns it
off, as `main` does. (`bench.py`'s own step feeds a bfloat16 image; the
benchmark's training cell takes that up.)

With remat, each step launches the deform and chain kernels twice per
block (forward and recompute: 42 each) and the deform backward kernel once
per block (21).

    python -m deformablelka_tpu_torch.train_path

runs two steps to warm up, then one under `torch.profiler` on the card,
and prints the wall time, the device's busy share and the device time by
kernel class and by kernel.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Callable
from unittest import mock

import numpy as np
import torch

from deformablelka_tpu_torch.main_path import BLOCKS, drive_gates
from deformablelka_tpu_torch.models.dlka_former import dlka_former_synapse
from deformablelka_tpu_torch.ops import convs, kernels
from deformablelka_tpu_torch.profiling import device_profile, print_profile
from deformablelka_tpu_torch.training.losses import poly_lr
from deformablelka_tpu_torch.training.train_step import make_sgd, make_train_step

PATCH = (64, 128, 128)
BATCH = 2
NUM_CLASSES = 14
LR = poly_lr(0, 1000, 1e-2)
# kernel launches per training step with remat (the 2D kernels and the
# dilated depthwise conv, which the published block does not reach: none)
LAUNCHES_PER_STEP = {"deform_conv3d": 2 * BLOCKS, "dw_chain3d": 2 * BLOCKS,
                     "deform_conv3d_bwd": BLOCKS, "dw_chain3d_bwd": BLOCKS, "conv3d_wgrad": 116}
# conv3d_wgrad: of the step's 155 dense stride-1 convs (7 a block, encoder1's
# 3, decoder2's 2, the three outputs), all but the 39 at 8³ and 4³, where
# cuDNN's weight gradient is the faster (`convs.hand_wgrad_shape`)


def dense_wgrad_sites(model: torch.nn.Module, shape) -> Counter:
    """{(B, D, H, W, Ci, Co, k): convs} over one forward of `model` (moved
    to the meta device) on a float32 input of `shape` (B, D, H, W, C): the
    convs whose weight gradient `ops.convs` can give the hand kernel
    (`convs.dense_unit_stride`, weights that require a gradient), each
    once a training step (remat's recompute asks no second gradient)."""
    sites = Counter()

    def record(x, w, st, pad, dil, groups):
        if w.requires_grad and convs.dense_unit_stride(x, w, st, pad, dil, groups):
            sites[(*x.shape, w.shape[0], w.shape[2])] += 1
        return False

    def deform(x, offset, w, bias=None):  # its shape alone: the plain gather is slow on meta
        return x.new_empty(*x.shape[:-1], w.shape[-1])

    model = model.to("meta")
    with mock.patch.object(convs, "_hand_wgrad", record), \
            mock.patch.object(kernels, "deform_conv3d", deform), torch.enable_grad():
        model(torch.zeros(shape, device="meta"))
    return sites


def hand_wgrads(sites: Counter) -> int:
    """The weight gradients among `sites` that the hand kernel computes
    (`convs.hand_wgrad_shape`)."""
    return sum(n for (B, D, H, W, ci, co, k), n in sites.items()
               if convs.hand_wgrad_shape(ci, co, k, B * D * H * W))


@dataclass
class TrainPath:
    model: torch.nn.Module
    train_step: Callable
    image: torch.Tensor
    label: torch.Tensor


def batch(seed: int = 0, img_size=PATCH, device="cuda"):
    """A seeded f32 image (B, *S, 1) and int64 labels (B, *S) in [0, 14)."""
    image = np.random.RandomState(seed).randn(BATCH, *img_size, 1)
    label = np.random.RandomState(seed + 1).randint(
        0, NUM_CLASSES, (BATCH, *img_size))
    return (torch.from_numpy(image.astype(np.float32)).to(device),
            torch.from_numpy(label.astype(np.int64)).to(device))


def build(seed: int = 0, img_size=PATCH, device="cuda") -> TrainPath:
    """The model (gates driven), its training step and one batch."""
    model = dlka_former_synapse(NUM_CLASSES, do_ds=True, img_size=img_size,
                                remat=True, seed=seed, device=device)
    drive_gates(model, seed + 11)
    image, label = batch(seed, img_size, device)
    return TrainPath(model, make_train_step(model, make_sgd(model.parameters(), LR)),
                     image, label)


def step(path: TrainPath) -> dict:
    """One training step on the path's batch: {"loss", "grad_norm"}."""
    return path.train_step(path.image, path.label)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    path = build()
    for _ in range(2):  # warm-up
        step(path)
    torch.cuda.synchronize()
    print_profile(f"training step B={BATCH} patch {PATCH}, remat, deep "
                  "supervision", device_profile(lambda: step(path)))


if __name__ == "__main__":
    main()
