"""Pancreas / LA-heart volumetric tester: stride-grid sliding window with
count blending + binary surface metrics.

Port of `deformablelka_tpu/inference/pancreas.py`. Upstream's behaviour:
  pancreas_code/test_util.py:17-43 — test_all_case: per-h5-case
    prediction, per-case (dice, jaccard, hd95, asd), averaged over
    cases; cases with an all-zero prediction score (0,0,0,0).
  test_util.py:46-111 — test_single_case: pad to ≥ patch (split evenly),
    step grid ceil((size-patch)/stride)+1 clamped at the border, softmax
    accumulated with a uniform count map, argmax, unpad. No Gaussian, no
    mirror TTA.
  test_util.py:121-127 — metrics via medpy binary dc/jc/hd95/asd.

The tile loop is the port's `SlidingWindowInference` in "stride" mode,
one tile per forward; the engine holds the model, so no parameters are
passed here. `input_dtype` is the type the model takes: the Pancreas CLI
passes `torch.bfloat16`, as the JAX CLI casts its tiles.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np

from deformablelka_tpu_torch.evaluation import metrics as M
from deformablelka_tpu_torch.inference.sliding_window import SlidingWindowInference


def make_pancreas_sliding_window(apply_fn: Callable, num_classes: int = 2,
                                 patch_size=(96, 96, 96), stride_xy: int = 16,
                                 stride_z: int = 16, device="cuda",
                                 input_dtype=None) -> SlidingWindowInference:
    return SlidingWindowInference(
        apply_fn, patch_size=patch_size, num_classes=num_classes,
        do_mirroring=False, use_gaussian=False, grid_mode="stride",
        stride_xy=stride_xy, stride_z=stride_z, device=device,
        input_dtype=input_dtype)


def test_single_case(sw: SlidingWindowInference, image: np.ndarray):
    """image: (W, H, D) float volume → (label_map (W,H,D) int, score_map
    (C, W, H, D) float) — same outputs as test_util.test_single_case."""
    probs = sw.predict(image[..., None].astype(np.float32))
    label_map = np.argmax(probs, axis=-1)
    return label_map, np.moveaxis(probs, -1, 0)


def calculate_metric_percase(pred, gt):
    """(dice, jaccard, hd95, asd) — test_util.py:121-127."""
    return (M.dice(pred, gt, nan_for_nonexisting=False), M.jaccard(pred, gt),
            M.hd95(pred, gt), M.asd(pred, gt))


def test_all_case(sw: SlidingWindowInference, cases: Sequence,
                  save_dir: Optional[str] = None,
                  preproc_fn: Optional[Callable] = None,
                  verbose: bool = True):
    """cases: iterable of (name, image, label) triples or h5 paths (these
    need h5py).

    Returns the 4-vector mean metric over cases (test_util.py:17-43)."""
    from deformablelka_tpu_torch.data.pancreas import load_case_h5

    total = np.zeros(4, np.float64)
    n = 0
    for case in cases:
        if isinstance(case, (str, Path)):
            name = Path(case).name
            image, label = load_case_h5(case)
        else:
            name, image, label = case
        if preproc_fn is not None:
            image = preproc_fn(image)
        pred, _ = test_single_case(sw, image)
        if pred.sum() == 0:
            single = (0.0, 0.0, 0.0, 0.0)
        else:
            single = calculate_metric_percase(pred, label)
        total += np.asarray(single, np.float64)
        n += 1
        if verbose:
            print(f"{name}: dice={single[0]:.4f} jc={single[1]:.4f} "
                  f"hd95={single[2]:.2f} asd={single[3]:.2f}")
        if save_dir is not None:
            from deformablelka_tpu_torch.data import nifti
            Path(save_dir).mkdir(parents=True, exist_ok=True)
            nifti.save(pred.astype(np.float32),
                       str(Path(save_dir) / f"{name}_pred.nii.gz"))
    avg = total / max(n, 1)
    if verbose:
        print(f"average metric is {avg}")
    return avg
