"""Score aggregation → summary.json.

The port's copy of `deformablelka_tpu/evaluation/evaluator.py` (numpy
and scipy). Parity target: upstream's 3D/d_lka_former/evaluation/
evaluator.py:30-483 — `aggregate_scores` evaluates (pred, gt) pairs per
label, writes a summary.json with per-case results and label-wise means.
Upstream parallelises with a process Pool; here evaluation is a plain map
(the EDT surface metrics are the cost; a Pool hook is provided)."""

from __future__ import annotations

import json
import multiprocessing
from pathlib import Path

import numpy as np

from deformablelka_tpu_torch.evaluation.metrics import per_class_metrics


def _eval_case(args):
    pred, gt, labels, spacing, compute_surface = args
    return per_class_metrics(pred, gt, labels, spacing, compute_surface)


def aggregate_scores(test_ref_pairs, labels, voxel_spacings=None,
                     json_output_file=None, json_name="", json_author="",
                     json_task="", num_threads: int = 0,
                     compute_surface: bool = True):
    """test_ref_pairs: list of (pred_seg, gt_seg) arrays (or callables
    returning them). Returns the summary dict (evaluator.py:322-402
    layout: {"all": [...], "mean": {...}})."""
    pairs = []
    for pred, gt in test_ref_pairs:
        if callable(pred):
            pred = pred()
        if callable(gt):
            gt = gt()
        pairs.append((pred, gt))
    spacings = voxel_spacings or [None] * len(pairs)
    args = [(p, g, labels, s, compute_surface)
            for (p, g), s in zip(pairs, spacings)]
    if num_threads and num_threads > 1:
        with multiprocessing.Pool(num_threads) as pool:
            all_scores = pool.map(_eval_case, args)
    else:
        all_scores = [_eval_case(a) for a in args]

    mean = {}
    for lab in labels:
        lab = str(lab)
        mean[lab] = {}
        keys = all_scores[0][lab].keys() if all_scores else []
        for k in keys:
            vals = [s[lab][k] for s in all_scores]
            mean[lab][k] = float(np.nanmean(
                np.asarray(vals, dtype=np.float64)))
    summary = {"name": json_name, "author": json_author, "task": json_task,
               "results": {"all": all_scores, "mean": mean}}
    if json_output_file is not None:
        Path(json_output_file).write_text(json.dumps(summary, indent=2))
    return summary


SYNAPSE_LABEL_MAP = {1: 1, 2: 2, 3: 3, 4: 4, 6: 5, 7: 6, 8: 7, 11: 8}
SYNAPSE_ORGANS = ["spleen", "right_kidney", "left_kidney", "gallbladder",
                  "liver", "stomach", "aorta", "pancreas"]


def remap_synapse_labels(seg: np.ndarray) -> np.ndarray:
    """The 8-organ Synapse label remap {1,2,3,4,6,7,8,11} → 1..8
    (3D/inference_synapse.py:23-33); everything else → 0."""
    out = np.zeros_like(seg)
    for src, dst in SYNAPSE_LABEL_MAP.items():
        out[seg == src] = dst
    return out


ACDC_STRUCTURES = {"rv": 1, "myo": 2, "lv": 3}


def evaluate_acdc_cases(pairs, out_file=None):
    """inference_acdc.py:16-140 equivalent: per-case RV/Myo/LV dice + HD95.

    Reference edge cases reproduced: dice = 1 when BOTH masks are empty
    (inference_acdc.py:16-20); hd95 = 0 unless both masks are non-empty
    (:47-52). Writes the `dice_pre.txt`-style report when out_file is
    given; returns {structure: {dice: [...], hd95: [...]}} + means."""
    from deformablelka_tpu_torch.evaluation.metrics import hd95 as _hd95

    per = {k: {"dice": [], "hd95": []} for k in ACDC_STRUCTURES}
    lines = []
    for i, (pred, gt) in enumerate(pairs):
        lines.append("*" * 20)
        lines.append(f"case_{i}")
        for name, lab in ACDC_STRUCTURES.items():
            p = pred == lab
            g = gt == lab
            if p.sum() + g.sum() == 0:
                d = 1.0
            else:
                d = 2.0 * np.logical_and(p, g).sum() / (p.sum() + g.sum())
            h = _hd95(p, g) if (p.sum() > 0 and g.sum() > 0) else 0.0
            per[name]["dice"].append(float(d))
            per[name]["hd95"].append(float(h))
            lines.append(f"Dice_{name}: {d:.4f}")
            lines.append(f"hd_{name}: {h:.4f}")
    summary = {"per_structure": per}
    summary["mean_dice"] = float(np.mean(
        [np.mean(per[k]["dice"]) for k in ACDC_STRUCTURES]))
    summary["mean_hd95"] = float(np.mean(
        [np.mean(per[k]["hd95"]) for k in ACDC_STRUCTURES]))
    lines.append("*" * 20)
    lines.append("Mean_Dice")
    for k in ACDC_STRUCTURES:
        lines.append(f"Dice_{k}{np.mean(per[k]['dice'])}")
    lines.append("Mean_HD")
    for k in ACDC_STRUCTURES:
        lines.append(f"HD_{k}{np.mean(per[k]['hd95'])}")
    lines.append(f"DSC:{summary['mean_dice']}")
    lines.append(f"HD:{summary['mean_hd95']}")
    if out_file is not None:
        Path(out_file).write_text("\n".join(lines) + "\n")
    return summary


def evaluate_synapse_cases(pairs, voxel_spacings=None, out_file=None):
    """inference_synapse.py:35-120 equivalent: remap to 8 organs, compute
    per-organ Dice + HD95, report per-case and mean."""
    remapped = [(remap_synapse_labels(p), remap_synapse_labels(g))
                for p, g in pairs]
    summary = aggregate_scores(remapped, labels=list(range(1, 9)),
                               voxel_spacings=voxel_spacings,
                               json_output_file=out_file,
                               json_name="synapse")
    organs = {str(i + 1): SYNAPSE_ORGANS[i] for i in range(8)}
    mean = summary["results"]["mean"]
    dsc = float(np.nanmean([mean[k]["Dice"] for k in organs]))
    hd = float(np.nanmean([mean[k].get("Hausdorff Distance 95", np.nan)
                           for k in organs]))
    summary["mean_dice"] = dsc
    summary["mean_hd95"] = hd
    return summary
