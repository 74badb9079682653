"""Segmentation metrics: Dice, Jaccard, HD, HD95, ASD, ASSD, confusion
counts and the normalized surface Dice.

The port's own copy of `deformablelka_tpu/evaluation/metrics.py` (numpy
and scipy only; the port imports nothing of the JAX package). The
distances reproduce medpy's `dc`, `jc`, `hd`, `hd95`, `asd` and `assd`,
which upstream's testers report: surfaces by binary erosion with a
connectivity-1 element, distances by `distance_transform_edt` of the
complement.
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


def jaccard(pred, gt):
    pred, gt = _to_bool(pred), _to_bool(gt)
    union = np.logical_or(pred, gt).sum()
    if union == 0:
        return float("nan")
    return np.logical_and(pred, gt).sum() / union


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


def hd(pred, gt, voxel_spacing=None):
    d1 = surface_distances(pred, gt, voxel_spacing)
    d2 = surface_distances(gt, pred, voxel_spacing)
    if d1 is None or d2 is None:
        return float("nan")
    return float(max(d1.max(), d2.max()))


def asd(pred, gt, voxel_spacing=None):
    """Directed average surface distance pred→gt (medpy asd — the metric
    upstream's pancreas tester reports, test_util.py:127)."""
    d1 = surface_distances(pred, gt, voxel_spacing)
    if d1 is None:
        return float("nan")
    return float(np.mean(d1))


def assd(pred, gt, voxel_spacing=None):
    """Average symmetric surface distance (upstream's metrics.py:350-384)."""
    d1 = surface_distances(pred, gt, voxel_spacing)
    d2 = surface_distances(gt, pred, voxel_spacing)
    if d1 is None or d2 is None:
        return float("nan")
    return float(np.mean(np.hstack([d1, d2])))


class ConfusionMatrix:
    """Per-label binary confusion counts (upstream's
    evaluation/metrics.py:19-100)."""

    def __init__(self, pred, gt):
        self.pred = _to_bool(pred)
        self.gt = _to_bool(gt)
        self.tp = int(np.logical_and(self.pred, self.gt).sum())
        self.fp = int(np.logical_and(self.pred, ~self.gt).sum())
        self.fn = int(np.logical_and(~self.pred, self.gt).sum())
        self.tn = int(np.logical_and(~self.pred, ~self.gt).sum())
        self.pred_empty = not self.pred.any()
        self.gt_empty = not self.gt.any()

    def dice(self):
        denom = 2 * self.tp + self.fp + self.fn
        return float("nan") if denom == 0 else 2 * self.tp / denom

    def jaccard(self):
        denom = self.tp + self.fp + self.fn
        return float("nan") if denom == 0 else self.tp / denom

    def precision(self):
        denom = self.tp + self.fp
        return float("nan") if denom == 0 else self.tp / denom

    def recall(self):
        denom = self.tp + self.fn
        return float("nan") if denom == 0 else self.tp / denom

    def specificity(self):
        denom = self.tn + self.fp
        return float("nan") if denom == 0 else self.tn / denom

    def accuracy(self):
        n = self.tp + self.fp + self.fn + self.tn
        return (self.tp + self.tn) / n if n else float("nan")


def per_class_metrics(pred_seg, gt_seg, labels, voxel_spacing=None,
                      compute_surface=True):
    """Per-label dict of dice/jaccard/hd95/assd + counts — the per-case
    payload of upstream's evaluator.aggregate_scores (evaluator.py:322-402)."""
    out = {}
    for lab in labels:
        p = pred_seg == lab
        g = gt_seg == lab
        cm = ConfusionMatrix(p, g)
        entry = {
            "Dice": cm.dice(), "Jaccard": cm.jaccard(),
            "Precision": cm.precision(), "Recall": cm.recall(),
            "Total Positives Test": int(p.sum()),
            "Total Positives Reference": int(g.sum()),
        }
        if compute_surface:
            entry["Hausdorff Distance 95"] = hd95(p, g, voxel_spacing)
            entry["Avg. Symmetric Surface Distance"] = assd(p, g,
                                                            voxel_spacing)
        out[str(lab)] = entry
    return out


def normalized_surface_dice(a, b, threshold: float, voxel_spacing=None,
                            connectivity=1):
    """Symmetric normalized surface dice (upstream's
    evaluation/surface_dice.py:20-57 — nnUNet's variant, which its own
    docstring notes differs from the official NSD): fraction of surface points of each mask within
    `threshold` mm of the other mask's surface,
    dc = (tp_a + tp_b) / (tp_a + tp_b + fp + fn)."""
    a_to_b = surface_distances(a, b, voxel_spacing, connectivity)
    b_to_a = surface_distances(b, a, voxel_spacing, connectivity)
    if a_to_b is None or b_to_a is None:
        return float("nan")
    tp_a = float(np.sum(a_to_b <= threshold)) / len(a_to_b)
    tp_b = float(np.sum(b_to_a <= threshold)) / len(b_to_a)
    fp = float(np.sum(a_to_b > threshold)) / len(a_to_b)
    fn = float(np.sum(b_to_a > threshold)) / len(b_to_a)
    return (tp_a + tp_b) / (tp_a + tp_b + fp + fn + 1e-8)
