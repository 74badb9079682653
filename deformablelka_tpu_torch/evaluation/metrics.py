"""Segmentation metrics for the port's evaluation: Dice and HD95.

The port's own copy of `dice` and `hd95` in
`deformablelka_tpu/evaluation/metrics.py` (numpy and scipy only; the port
imports nothing of the JAX package). They reproduce medpy's `dc` and
`hd95`, which upstream's `test_single_volume` reports: surfaces by binary
erosion with a connectivity-1 element, distances by
`distance_transform_edt` of the complement.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def _to_bool(a):
    return np.asarray(a).astype(bool)


def dice(pred, gt, nan_for_nonexisting=True):
    pred, gt = _to_bool(pred), _to_bool(gt)
    denom = pred.sum() + gt.sum()
    if denom == 0:
        return float("nan") if nan_for_nonexisting else 0.0
    return 2.0 * np.logical_and(pred, gt).sum() / denom


def _surface(mask, connectivity=1):
    """Boundary voxels of a binary mask: the mask minus its erosion."""
    conn = ndimage.generate_binary_structure(mask.ndim, connectivity)
    eroded = ndimage.binary_erosion(mask, structure=conn, iterations=1)
    return mask ^ eroded


def surface_distances(pred, gt, voxel_spacing=None, connectivity=1):
    """Distances from each pred-surface voxel to the nearest gt surface
    voxel (medpy's one-sided surface distances); None if either is empty."""
    pred, gt = _to_bool(pred), _to_bool(gt)
    if pred.sum() == 0 or gt.sum() == 0:
        return None
    pred_surf = _surface(pred, connectivity)
    gt_surf = _surface(gt, connectivity)
    dt = ndimage.distance_transform_edt(~gt_surf, sampling=voxel_spacing)
    return dt[pred_surf]


def hd95(pred, gt, voxel_spacing=None):
    """95th-percentile symmetric Hausdorff distance (medpy hd95)."""
    d1 = surface_distances(pred, gt, voxel_spacing)
    d2 = surface_distances(gt, pred, voxel_spacing)
    if d1 is None or d2 is None:
        return float("nan")
    return float(np.percentile(np.hstack([d1, d2]), 95))
