"""Region-based evaluation (composed-label dice).

The port's copy of `deformablelka_tpu/evaluation/region_based.py`, on
the port's `evaluation/metrics.dice` and `data/nifti.py`. Upstream's
behaviour: evaluation/region_based_evaluation.py — regions are tuples of
labels merged into one binary mask (e.g. BraTS whole tumor = {1,2,3});
per-case dice per region, aggregated to means over a folder of
(predicted, gt) NIfTI pairs.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from deformablelka_tpu_torch.evaluation.metrics import dice


def get_brats_regions() -> dict:
    return {"whole tumor": (1, 2, 3), "tumor core": (2, 3),
            "enhancing tumor": (3,)}


def get_kits_regions() -> dict:
    return {"kidney incl tumor": (1, 2), "tumor": (2,)}


def create_region_from_mask(mask: np.ndarray, join_labels) -> np.ndarray:
    out = np.zeros_like(mask, dtype=np.uint8)
    for lab in join_labels:
        out[mask == lab] = 1
    return out


def evaluate_case_regions(pred: np.ndarray, gt: np.ndarray,
                          regions) -> list:
    """Per-region dice for one case; NaN when the region is absent from
    both (region_based_evaluation.evaluate_case semantics)."""
    results = []
    for r in regions:
        mp = create_region_from_mask(pred, r)
        mg = create_region_from_mask(gt, r)
        if mp.sum() == 0 and mg.sum() == 0:
            results.append(float("nan"))
        else:
            results.append(dice(mp, mg, nan_for_nonexisting=False))
    return results


def evaluate_regions(folder_predicted, folder_gt, regions: dict,
                     out_csv=None) -> dict:
    """Folder-level region evaluation → {region: per-case list} +
    'mean' row; optional summary.csv like the reference writes."""
    from deformablelka_tpu_torch.data import nifti
    folder_predicted = Path(folder_predicted)
    folder_gt = Path(folder_gt)
    preds = sorted(p.name for p in folder_predicted.glob("*.nii.gz"))
    gts = {p.name for p in folder_gt.glob("*.nii.gz")}
    missing = [f for f in preds if f not in gts]
    assert not missing, f"predictions without ground truth: {missing}"
    names = list(regions.keys())
    all_results = {r: [] for r in names}
    cases = []
    for f in preds:
        pred = nifti.load(folder_predicted / f).data
        gt = nifti.load(folder_gt / f).data
        res = evaluate_case_regions(pred, gt, list(regions.values()))
        cases.append((f, res))
        for n, v in zip(names, res):
            all_results[n].append(v)
    summary = {n: {"cases": all_results[n],
                   "mean": float(np.nanmean(all_results[n]))
                   if all_results[n] else float("nan")}
               for n in names}
    if out_csv is not None:
        with open(out_csv, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["case"] + names)
            for f, res in cases:
                w.writerow([f] + [f"{v:.4f}" for v in res])
            w.writerow(["mean"] + [f"{summary[n]['mean']:.4f}"
                                   for n in names])
    return summary
