"""End-to-end 3D case prediction: preprocess → sliding window → restore
original geometry → export NIfTI.

Port of `deformablelka_tpu/inference/predictor3d.py`. Parity targets
(upstream):
  inference/predict.py:133-805 — `predict_cases` (multi-fold softmax
  averaging), `predict_from_folder`, the CLI's loop over a folder.
  segmentation_export.py:27-233 — `save_segmentation_nifti_from_softmax`:
  resample the softmax back to the pre-resampling shape (separate-z
  logic mirrored from preprocessing), reinsert into the original
  full-size volume via the stored crop bbox, write NIfTI.

Preprocessing and the restore run on the host in numpy and scipy, as in
the JAX package; the folds' probabilities are summed on the device and
fetched once, then averaged probabilities (never per-fold labels) are
restored. The NIfTI's on-disk (x, y, z) axis order and spacing are kept
throughout, as in the JAX package (upstream feeds (z, y, x) after
SimpleITK).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Sequence

import numpy as np

from deformablelka_tpu_torch.data import nifti
from deformablelka_tpu_torch.data.preprocessing import (
    GenericPreprocessor, get_do_separate_z, get_lowres_axis, resample_data_or_seg)
from deformablelka_tpu_torch.inference.sliding_window import SlidingWindowInference

TTA_BATCH = 8  # the flips of a tile per forward: all 8, as on the main path


def restore_softmax_to_original(softmax: np.ndarray, properties: dict,
                                order: int = 1) -> np.ndarray:
    """softmax: (x, y, z, C) in preprocessed space → argmax seg in the
    ORIGINAL image geometry (segmentation_export.py:27-157)."""
    shape_after_crop = [hi - lo for lo, hi in properties["crop_bbox"]]
    cur = list(softmax.shape[:3])
    if cur != shape_after_crop:
        spacing_now = properties["target_spacing"]
        spacing_orig = properties["original_spacing"]
        do_sep = (get_do_separate_z(spacing_now)
                  or get_do_separate_z(spacing_orig))
        axis = (get_lowres_axis(spacing_orig) if do_sep else None)
        # (C, x, y, z), made contiguous: scipy's zoom of a channel of the
        # strided view gives the same values many times more slowly
        data = np.ascontiguousarray(np.moveaxis(softmax, -1, 0))
        data = resample_data_or_seg(data, shape_after_crop, is_seg=False,
                                    axis=axis, order=order,
                                    do_separate_z=do_sep, order_z=0)
        softmax = np.moveaxis(data, 0, -1)
    seg = np.argmax(softmax, axis=-1).astype(np.uint8)
    out = np.zeros(properties["original_shape"], np.uint8)
    slicer = tuple(slice(lo, hi) for lo, hi in properties["crop_bbox"])
    out[slicer] = seg
    return out


class Predictor3D:
    """Single- or multi-fold case predictor.

    `models_per_fold`: one callable per fold mapping a (b, *patch, C)
    float32 tensor on `device` to logits (a module with its fold's
    weights, `model_restore.load_model_and_checkpoint_files`). The 2^k
    mirror flips of a tile run as one forward. After each case,
    `last_case` holds its preprocessed shape, its tile count and the
    seconds of preprocessing, prediction (the folds and the one fetch)
    and the restore (and of the whole file, from `predict_file`).
    """

    def __init__(self, models_per_fold: Sequence, preprocessor: GenericPreprocessor,
                 patch_size, num_classes: int, step_size: float = 0.5,
                 do_mirroring: bool = True, device="cuda"):
        self.preprocessor = preprocessor
        self.engines = [SlidingWindowInference(
            model, patch_size=patch_size, num_classes=num_classes,
            step_size=step_size, do_mirroring=do_mirroring,
            tta_batch=TTA_BATCH, device=device) for model in models_per_fold]
        if not self.engines:
            raise ValueError("no fold to predict with")
        self.last_case = {}

    def predict_case(self, data: np.ndarray, spacing) -> tuple:
        """data: (C, x, y, z) raw. Returns (seg_in_original_space,
        softmax, properties)."""
        t0 = time.perf_counter()
        pre, _, props = self.preprocessor.preprocess(data, spacing)
        vol = np.moveaxis(pre, 0, -1)  # channels-last
        t1 = time.perf_counter()
        total = None
        for sw in self.engines:
            p, slicer = sw.predict(vol, return_device=True)
            if total is None:
                total = p
            else:
                total += p
        probs = (total / len(self.engines)).cpu().numpy()[slicer]
        t2 = time.perf_counter()
        seg = restore_softmax_to_original(probs, props)
        padded = [max(s, p) for s, p in zip(vol.shape[:3], self.engines[0].patch_size)]
        self.last_case = {
            "preprocessed_shape": tuple(vol.shape[:3]),
            "tiles": len(self.engines[0].origins(padded)),
            "preprocess_s": t1 - t0, "predict_s": t2 - t1,
            "restore_s": time.perf_counter() - t2}
        return seg, probs, props

    def predict_file(self, in_path: str | Path, out_path: str | Path):
        """Read a NIfTI case, predict it, write its uint8 labels with the
        case's affine; `last_case["case_s"]` is the whole call's seconds."""
        t0 = time.perf_counter()
        img = nifti.load(in_path)
        data = np.asarray(img.data, np.float32)[None]
        seg, _, _ = self.predict_case(data, img.spacing)
        nifti.save(seg.astype(np.uint8), out_path, affine=img.affine)
        self.last_case["case_s"] = time.perf_counter() - t0
        return seg


def predict_from_folder(predictor: Predictor3D, input_folder, output_folder,
                        suffix=".nii.gz"):
    """The folder loop (predict.py:579): every `*suffix` case of
    `input_folder`, in name order, to the same name in `output_folder`."""
    input_folder = Path(input_folder)
    output_folder = Path(output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)
    results = []
    for f in sorted(input_folder.glob(f"*{suffix}")):
        out = output_folder / f.name
        predictor.predict_file(f, out)
        results.append(out)
    return results
