"""2D volumetric inference: slice-by-slice prediction with zoom to the model
size, per-class Dice and HD95, and the batch-1 latency harness.

Port of `deformablelka_tpu/inference/predictor2d.py` (upstream's
`test_single_volume`, `2D/utils.py:63-110`): each axial slice is zoomed on
the host to the model's patch (scipy, order 3), the slices go through the
model `slice_batch` at a time (the last chunk zero-padded to the same
batch), the argmax runs on the device and only uint8 labels come back, and
each label slice is zoomed back to the case's size (order 0).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch
from scipy.ndimage import zoom

from deformablelka_tpu_torch.evaluation.metrics import dice, hd95


class Predictor2D:
    """`model` maps (B, H, W, 1) float32 to (B, H, W, num_classes) logits;
    it runs on `device` (the card unless the caller asks for the CPU)."""

    def __init__(self, model: torch.nn.Module, patch_size=(224, 224),
                 num_classes: int = 9, slice_batch: int = 24, device="cuda"):
        self.model = model
        self.patch_size = tuple(patch_size)
        self.num_classes = num_classes
        self.slice_batch = slice_batch
        self.device = torch.device(device)
        if num_classes > 256:
            raise ValueError("labels are fetched as uint8")

    @torch.no_grad()
    def _labels(self, chunk: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(chunk).to(self.device)
        return self.model(x).argmax(-1).to(torch.uint8).cpu().numpy()

    def to_patch(self, image: np.ndarray) -> np.ndarray:
        """(S, H, W) → (S, ph, pw, 1) float32, each slice zoomed (order 3)
        on the host."""
        S, H, W = image.shape
        ph, pw = self.patch_size
        if (H, W) != (ph, pw):
            image = np.stack([zoom(image[i], (ph / H, pw / W), order=3)
                              for i in range(S)])
        return image[..., None].astype(np.float32)

    def from_patch(self, pred: np.ndarray, size) -> np.ndarray:
        """(S, ph, pw) labels → (S, H, W) int32, each slice zoomed back
        (order 0) on the host."""
        H, W = size
        ph, pw = self.patch_size
        if (H, W) != (ph, pw):
            pred = np.stack([zoom(p, (H / ph, W / pw), order=0) for p in pred])
        return pred.astype(np.int32)

    def predict_slices(self, slices: np.ndarray) -> np.ndarray:
        """(S, ph, pw, 1) → (S, ph, pw) uint8 labels, `slice_batch` slices
        per forward, the last chunk zero-padded."""
        B = self.slice_batch
        preds = []
        for i in range(0, slices.shape[0], B):
            chunk = slices[i:i + B]
            n = chunk.shape[0]
            if n < B:
                chunk = np.concatenate(
                    [chunk, np.zeros((B - n, *chunk.shape[1:]), np.float32)])
            preds.append(self._labels(chunk)[:n])
        return np.concatenate(preds)

    def predict_volume(self, image: np.ndarray) -> np.ndarray:
        """image: (S, H, W) float, slices first. Returns (S, H, W) int32
        labels."""
        return self.from_patch(self.predict_slices(self.to_patch(image)),
                               image.shape[1:])

    def evaluate_case(self, image: np.ndarray, label: np.ndarray,
                      classes: Optional[Sequence[int]] = None, spacing=None):
        """The labels and, per class, (dice, hd95), as upstream's
        `calculate_metric_percase`."""
        pred = self.predict_volume(image)
        classes = classes or list(range(1, self.num_classes))
        out = []
        for c in classes:
            p, g = pred == c, label == c
            if p.sum() > 0 and g.sum() > 0:
                out.append((dice(p, g), hd95(p, g, spacing)))
            elif p.sum() > 0:
                out.append((0.0, 0.0))
            else:
                out.append((1.0 if g.sum() == 0 else 0.0, 0.0))
        return pred, out


@torch.no_grad()
def benchmark_inference_speed(model: torch.nn.Module, patch_size=(224, 224),
                              warmup: int = 50, reps: int = 1000,
                              batch: int = 1, device="cuda"):
    """Forward latency, upstream's `test_inference_speed.py:23-55`: a
    zero (batch, H, W, 1) input, `warmup` calls, then `reps` timed calls,
    each ended by a device synchronise. Returns (mean, std) in ms."""
    device = torch.device(device)
    x = torch.zeros(batch, *patch_size, 1, device=device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    for _ in range(warmup):
        model(x)
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        model(x)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.mean(times)), float(np.std(times))
