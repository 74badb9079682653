"""Connected-component postprocessing.

The port's copy of `deformablelka_tpu/evaluation/postprocessing.py`
(numpy and scipy), with the same results; `largest_cc_only` removes the
small objects in one pass over the volume rather than one per object. Parity target: upstream's 3D/d_lka_former/
postprocessing/connected_components.py:48-428 —
`remove_all_but_the_largest_connected_component` keeps, per class (or
class group), only the largest CC; `determine_postprocessing` decides per
class on validation data whether doing so improves the aggregated dice,
and stores the decision as JSON.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
from scipy import ndimage

from deformablelka_tpu_torch.evaluation.metrics import dice


def largest_cc_only(seg: np.ndarray, for_which_classes=None,
                    volume_per_voxel: float = 1.0,
                    minimum_valid_object_size=None):
    """Keep only the largest connected component for each listed class.

    Returns (new_seg, largest_removed_size_per_class, kept_size_per_class).
    Classes may be ints or tuples of ints (treated as a joint region),
    matching connected_components.py:48-117.
    """
    if for_which_classes is None:
        for_which_classes = [int(c) for c in np.unique(seg) if c > 0]
    seg = np.copy(seg)
    largest_removed, kept_size = {}, {}
    for c in for_which_classes:
        if isinstance(c, (list, tuple)):
            c = tuple(c)
            mask = np.zeros(seg.shape, bool)
            for cc in c:
                mask |= seg == cc
        else:
            mask = seg == c
        labeled, n = ndimage.label(mask)
        if n == 0:
            continue
        sizes = ndimage.sum(mask, labeled, range(1, n + 1)) * volume_per_voxel
        largest = int(np.argmax(sizes)) + 1
        kept_size[c] = float(sizes[largest - 1])
        largest_removed[c] = None
        min_size = (minimum_valid_object_size.get(c)
                    if minimum_valid_object_size else None)
        # every object but the largest (and those of at least min_size) in
        # one pass over the volume: the JAX package's loop makes one pass
        # per object, which a noisy prediction's thousands of objects
        # make minutes long
        remove = np.ones(n + 1, bool)
        remove[0] = remove[largest] = False
        if min_size is not None:
            remove[1:] &= sizes < min_size
        if remove.any():
            seg[remove[labeled] & mask] = 0
            largest_removed[c] = float(sizes[remove[1:]].max())
    return seg, largest_removed, kept_size


def determine_postprocessing(cases, labels, out_json: str | Path | None = None,
                             dice_threshold: float = 0.0):
    """Decide per class whether largest-CC filtering helps.

    cases: list of (pred_seg, gt_seg) numpy pairs (validation set).
    Returns {"for_which_classes": [...], "dice_before": {...},
    "dice_after": {...}} and optionally writes JSON — the functional core
    of connected_components.py:122-…
    """
    before = {c: [] for c in labels}
    after = {c: [] for c in labels}
    for pred, gt in cases:
        pp, _, _ = largest_cc_only(pred, for_which_classes=list(labels))
        for c in labels:
            before[c].append(dice(pred == c, gt == c))
            after[c].append(dice(pp == c, gt == c))
    keep = []
    mean_before, mean_after = {}, {}
    for c in labels:
        mb = float(np.nanmean(before[c])) if len(before[c]) else float("nan")
        ma = float(np.nanmean(after[c])) if len(after[c]) else float("nan")
        mean_before[str(c)] = mb
        mean_after[str(c)] = ma
        if np.isfinite(ma) and np.isfinite(mb) and ma > mb + dice_threshold:
            keep.append(int(c))
    result = {"for_which_classes": keep, "dice_before": mean_before,
              "dice_after": mean_after}
    if out_json is not None:
        Path(out_json).write_text(json.dumps(result, indent=2))
    return result
