"""Cascade support: predict the low-res stage for the full-res stage.

Port of `deformablelka_tpu/training/cascade.py`. Parity target:
upstream's training/cascade_stuff/predict_next_stage.py — for every case
of the low-res trainer, run sliding-window softmax prediction, resample
the softmax to the NEXT stage's case shape (order 1), argmax, and save
`<case>_segFromPrevStage.npz`. The full-res cascade trainer then appends
the previous-stage segmentation as one-hot input channels
(`data/dataset.DataLoader3D`'s cascade path).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from deformablelka_tpu_torch.data.dataset import load_case, load_dataset
from deformablelka_tpu_torch.data.preprocessing import resample_data_or_seg
from deformablelka_tpu_torch.inference.sliding_window import (
    SlidingWindowInference)


def resample_and_save(predicted_softmax: np.ndarray, target_shape,
                      output_file, order: int = 1,
                      order_z: int = 0) -> Path:
    """Softmax (ncls, x, y, z) → argmax seg at `target_shape`, saved as
    npz {"data": uint8} (predict_next_stage.resample_and_save)."""
    resampled = resample_data_or_seg(
        np.asarray(predicted_softmax, np.float32), target_shape,
        is_seg=False, order=order, order_z=order_z)
    seg = resampled.argmax(0).astype(np.uint8)
    output_file = Path(output_file)
    output_file.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(output_file, data=seg)
    return output_file


def predict_next_stage(apply_fn, lowres_folder, next_stage_folder,
                       output_folder, *, patch_size, num_classes: int,
                       step_size: float = 0.5, do_mirroring: bool = True,
                       cases=None, device="cuda") -> list:
    """Run the low-res model over preprocessed low-res cases and write
    `<case>_segFromPrevStage.npz` files resampled to the next stage's
    case shapes.

    apply_fn: (b, *patch, C) float32 tensor → logits, or a deep-
    supervision list whose first entry is used (a model in eval mode, on
    `device`). lowres_folder / next_stage_folder: preprocessed npz folders
    (nnUNet layout, image channels + seg stacked); the output goes where
    DataLoader3D's `seg_from_prev_stage_folder` will read it.
    """
    lowres = load_dataset(lowres_folder)
    nextst = load_dataset(next_stage_folder)
    output_folder = Path(output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)
    sw = SlidingWindowInference(apply_fn, patch_size=patch_size,
                                num_classes=num_classes,
                                step_size=step_size,
                                do_mirroring=do_mirroring, device=device)
    written = []
    for case in sorted(cases or lowres.keys()):
        data, _ = load_case(lowres[case])
        img = np.asarray(data[:-1], np.float32)  # drop stacked seg
        vol = np.moveaxis(img, 0, -1)            # (x, y, z, C)
        probs = sw.predict(vol)                  # (x, y, z, ncls)
        softmax = np.moveaxis(probs, -1, 0)
        if case in nextst:
            target_data, _ = load_case(nextst[case])
            target_shape = target_data.shape[1:]
        else:
            target_shape = img.shape[1:]
        out = resample_and_save(
            softmax, target_shape,
            output_folder / f"{case}_segFromPrevStage.npz")
        written.append(out)
    return written
